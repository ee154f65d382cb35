"""Lockstep host oracle for the batched SWIM engine.

One host :class:`~ringpop_tpu_torch.models.membership.host.Membership` instance per
simulated node — the object model mirrored from the reference
(lib/membership/member.js precedence rules, lib/membership/index.js:48-123
checksum strings hashed with the C++ FarmHash oracle) — driven through the
exact per-tick phase schedule of :mod:`ringpop_tpu_torch.models.sim.engine`:

    kill/revive -> join -> iterator target selection -> sender piggyback ->
    delivery -> receiver apply -> receiver piggyback -> responses/full-sync ->
    ping-req -> suspicion expiry -> checksums

The *decision plane* (who pings whom, which packets drop, ping-req fanout
picks, iterator reshuffles) reuses the port engine's own deterministic RNG
helpers (``engine._uniform`` / ``engine._fold``) on CPU tensors, so both
sides see the identical message schedule.  Everything *semantic* — SWIM update
precedence, refutation, new-member acceptance, dissemination budgets and
expiry, the receiver-origin filter, full-sync, suspicion timers, checksum
string construction and FarmHash32 — runs through the independent host
object model.  ``tick()`` returns per-node uint32 checksums that must equal
``SimState.checksum`` bit-for-bit every tick; any divergence in either
implementation's protocol semantics surfaces as a checksum mismatch.

Reference contracts validated transitively: membership checksum
(lib/membership/index.js:48-123), SWIM precedence (member.js:171-202),
refute (member.js:76-81,155-169), dissemination budget/filter/full-sync
(lib/gossip/dissemination.js:38-114,133-176), suspicion (suspicion.js),
convergence = all live checksums equal
(benchmarks/convergence-time/scenario-runner.js:152-170).

The port's copy of ``ringpop_tpu/parity/oracle.py``.  It is host code by
nature: the card runs only the engine it is held against
(``parity/check.py``).  Its checksums come from the C++ FarmHash
(``ops/native.py``), never from the port's own hash ops.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ringpop_tpu_torch.models.membership.host import Membership, Status
from ringpop_tpu_torch.models.membership.host import Update as HostUpdate
from ringpop_tpu_torch.models.sim import engine
from ringpop_tpu_torch.ops import checksum_encode as ce
from ringpop_tpu_torch.ops import native
from ringpop_tpu_torch.utils.config import Config
from ringpop_tpu_torch.utils.util import null_logger

STATUS_STR = ce.STATUS_STRINGS  # code -> string
STATUS_CODE = {s: i for i, s in enumerate(STATUS_STR)}


def _np_uniform(rng: np.ndarray, shape, salt: int) -> np.ndarray:
    """Engine ``_uniform`` evaluated on the host (same ops, same bits), on
    a CPU tensor view of the [N, 2] uint32 key words."""
    words = torch.from_numpy(np.ascontiguousarray(rng, np.uint32).view(np.int32))
    return engine._uniform(words, shape, salt).numpy()


def _np_fold(rng: np.ndarray, salt: int) -> np.ndarray:
    words = torch.from_numpy(np.ascontiguousarray(rng, np.uint32).view(np.int32))
    return engine._fold(words, salt).numpy().view(np.uint32)


def _digits(x: int) -> int:
    """Integer digit count — engine ``_max_piggyback``'s inner loop."""
    return sum(1 for k in range(10) if x >= 10**k)


class _Ctx:
    """Per-node ringpop stub for the host Membership (clock-controlled,
    always ready — the engine applies updates directly, no stashing)."""

    def __init__(self, address: str):
        self.host_port = address
        self.is_ready = True
        self.logger = null_logger()
        self.config = Config(self)
        self._now_ms = 0

    def whoami(self) -> str:
        return self.host_port

    def now(self) -> int:
        return self._now_ms

    def stat(self, *a, **k) -> None:
        pass


@dataclasses.dataclass
class _Change:
    """Dissemination change-table entry (dissemination.js ``this.changes``)."""

    status: int  # code
    inc: int
    source: int  # node index
    source_inc: int
    pb: int = 0


@dataclasses.dataclass
class OracleTickResult:
    checksums: np.ndarray  # [N] uint32
    converged: bool
    distinct_checksums: int
    full_syncs: int
    pings_sent: int


class _Node:
    def __init__(self, cluster: "OracleCluster", idx: int, now_ms: int):
        self.idx = idx
        addr = cluster.addresses[idx]
        self.ctx = _Ctx(addr)
        self.ctx._now_ms = now_ms
        self.membership = Membership(self.ctx, rng=random.Random(idx))
        # the Member state machine reaches back through the ringpop context
        # for LocalMemberLeaveEvent emission (host.py Member.evaluate_update)
        self.ctx.membership = self.membership
        self.membership.make_alive(addr, now_ms)
        self.changes: Dict[int, _Change] = {}
        self.susp: Dict[int, int] = {}  # subject -> deadline tick


class OracleCluster:
    """N host-membership nodes stepped in engine phase order.

    Mirror of ``engine.init_state`` + ``engine.tick`` at the semantic level;
    see module docstring.  ``seed`` must match the engine's so the decision
    plane coincides.
    """

    def __init__(self, params: engine.SimParams, addresses: Sequence[str], seed: int = 0):
        if len(addresses) != params.n:
            raise ValueError("addresses must have length params.n")
        self.params = params
        self.addresses = tuple(sorted(addresses))
        self.addr_idx = {a: i for i, a in enumerate(self.addresses)}
        n = params.n
        # engine.init_state's exact RNG draws (same numpy generator)
        rng = np.random.default_rng(seed)
        self.perm = np.stack([rng.permutation(n) for _ in range(n)]).astype(np.int32)
        self.rng = rng.integers(1, 2**32 - 1, size=(n, 2), dtype=np.uint32)
        self.iter_pos = np.zeros(n, np.int32)
        self.tick_index = 0
        self.proc_alive = np.ones(n, bool)
        self.ready = np.zeros(n, bool)
        self.gossip_on = np.ones(n, bool)
        self.partition = np.zeros(n, np.int32)
        self.checksum = np.zeros(n, np.uint32)  # cached, as engine caches
        self.nodes = [_Node(self, i, params.epoch_ms) for i in range(n)]

    # -- view helpers -----------------------------------------------------

    def _views(self):
        """(known, status, inc) [N, N] arrays from the host memberships."""
        n = self.params.n
        known = np.zeros((n, n), bool)
        status = np.zeros((n, n), np.int32)
        inc = np.zeros((n, n), np.int64)
        for i, node in enumerate(self.nodes):
            for m in node.membership.members:
                j = self.addr_idx[m.address]
                known[i, j] = True
                status[i, j] = STATUS_CODE[m.status]
                inc[i, j] = m.incarnation_number
        return known, status, inc

    def _self_inc(self, i: int) -> int:
        m = self.nodes[i].membership.find_member_by_address(self.addresses[i])
        return m.incarnation_number if m is not None else 0

    def _apply(self, i: int, updates: List[dict], tick_next: int) -> List:
        """Apply updates through node i's host Membership; maintain the
        change table + suspicion deadlines like engine._apply_updates."""
        node = self.nodes[i]
        applied = node.membership.update(updates)
        p = self.params
        for u in applied:
            j = self.addr_idx[u.address]
            node.changes[j] = _Change(
                status=STATUS_CODE[u.status],
                inc=u.incarnation_number,
                source=self.addr_idx.get(u.source, -1),
                source_inc=u.source_incarnation_number
                if u.source_incarnation_number is not None
                else 0,
                pb=0,
            )
            if u.status == Status.suspect and j != i:
                node.susp[j] = tick_next + p.suspicion_ticks
            elif u.status != Status.suspect:
                node.susp.pop(j, None)
        return applied

    def _compute_checksums(self) -> np.ndarray:
        out = np.zeros(self.params.n, np.uint32)
        for i, node in enumerate(self.nodes):
            s = node.membership.generate_checksum_string()
            out[i] = native.hash32(s)
        return out

    # -- the tick ---------------------------------------------------------

    def tick(self, inputs: Optional[dict] = None) -> OracleTickResult:
        p = self.params
        n = p.n
        inputs = inputs or {}
        kill = np.asarray(inputs.get("kill", np.zeros(n, bool)), bool)
        revive = np.asarray(inputs.get("revive", np.zeros(n, bool)), bool)
        join_in = np.asarray(inputs.get("join", np.zeros(n, bool)), bool)
        part_in = np.asarray(
            inputs.get("partition", np.full(n, -1, np.int32)), np.int32
        )

        leave_in = np.asarray(inputs.get("leave", np.zeros(n, bool)), bool)
        resume_in = np.asarray(inputs.get("resume", np.zeros(n, bool)), bool)

        tick_next = self.tick_index + 1
        now_ms = p.epoch_ms + tick_next * p.period_ms
        for node in self.nodes:
            node.ctx._now_ms = now_ms

        # ---- phase 0: fault plane --------------------------------------
        prev_alive = self.proc_alive.copy()
        self.proc_alive = (self.proc_alive & ~kill) | revive | resume_in
        self.partition = np.where(part_in >= 0, part_in, self.partition)
        rv = revive & ~prev_alive
        for i in np.flatnonzero(rv):
            self.nodes[i] = _Node(self, int(i), now_ms)
            self.nodes[i].ctx._now_ms = now_ms
            self.ready[i] = False
            self.gossip_on[i] = True
        self.tick_index = tick_next

        # ---- phase 0.5: graceful leave + rejoin-from-leave -------------
        # (engine phase 0.5; makeLeave at current incarnation, gossip off;
        # rejoin = alive with fresh incarnation, gossip back on)
        for i in np.flatnonzero(leave_in & self.proc_alive & self.ready):
            mem = self.nodes[i].membership
            m = mem.find_member_by_address(self.addresses[i])
            if m is None or m.status == Status.leave:
                continue
            self._apply(
                i,
                [
                    {
                        "address": self.addresses[i],
                        "status": Status.leave,
                        "incarnationNumber": m.incarnation_number,
                        "source": self.addresses[i],
                        "sourceIncarnationNumber": m.incarnation_number,
                    }
                ],
                tick_next,
            )
            self.gossip_on[i] = False
        for i in np.flatnonzero(join_in & self.proc_alive & self.ready):
            m = self.nodes[i].membership.find_member_by_address(
                self.addresses[i]
            )
            if m is None or m.status != Status.leave:
                continue
            self._apply(
                i,
                [
                    {
                        "address": self.addresses[i],
                        "status": Status.alive,
                        "incarnationNumber": now_ms,
                        "source": self.addresses[i],
                        "sourceIncarnationNumber": now_ms,
                    }
                ],
                tick_next,
            )
            self.gossip_on[i] = True

        # ---- phase 1: join ----------------------------------------------
        joiner = (join_in | rv) & self.proc_alive & ~self.ready
        known0, status0, inc0 = self._views()  # pre-join snapshot
        eye = np.eye(n, dtype=bool)
        conn = self.partition[:, None] == self.partition[None, :]
        can_join = joiner[:, None] & self.proc_alive[None, :] & ~eye & conn
        jrand = _np_uniform(self.rng, (n, n), salt=101)
        jscore = np.where(can_join, jrand, np.float32(2.0))
        jorder = np.argsort(jscore, axis=1, kind="stable")[:, : p.join_size]
        jvalid = np.take_along_axis(jscore, jorder, axis=1) < 1.5

        joined = joiner & jvalid.any(axis=1)
        for i in np.flatnonzero(joined):
            node = self.nodes[i]
            mem = node.membership
            # key-max merge of targets' views into the joiner's view,
            # bypassing the precedence gate — join installs the aggregated
            # response verbatim (join-sender aggregate + join-response-merge;
            # engine phase 1 direct overwrite).  The joiner's own entry is
            # protected (engine keep_self).
            for k in range(p.join_size):
                if not jvalid[i, k]:
                    continue
                t = int(jorder[i, k])
                for j in np.flatnonzero(known0[t]):
                    if j == i:
                        continue
                    addr = self.addresses[j]
                    key_t = int(inc0[t, j]) * 4 + int(status0[t, j])
                    m = mem.find_member_by_address(addr)
                    if m is None:
                        u = HostUpdate(
                            addr,
                            int(inc0[t, j]),
                            STATUS_STR[status0[t, j]],
                            source=self.addresses[i],
                            source_incarnation_number=self._self_inc(i),
                        )
                        m = mem._create_member(u)
                        mem.members.insert(mem.get_join_position(), m)
                        mem.members_by_address[addr] = m
                    elif key_t > m.incarnation_number * 4 + STATUS_CODE[m.status]:
                        m.status = STATUS_STR[status0[t, j]]
                        m.incarnation_number = int(inc0[t, j])
            mem.compute_checksum()
            self.ready[i] = True
            # record every known non-self member as a change
            # (set handler -> dissemination.recordChange, engine `learned`)
            own_inc = self._self_inc(i)
            for m in mem.members:
                j = self.addr_idx[m.address]
                if j == i:
                    continue
                node.changes[j] = _Change(
                    status=STATUS_CODE[m.status],
                    inc=m.incarnation_number,
                    source=i,
                    source_inc=own_inc,
                    pb=0,
                )

        # contacted targets makeAlive(joiner) (server/protocol/join.js:126)
        ja: Dict[int, List[dict]] = {}
        for i in np.flatnonzero(joined):
            own_inc = self._self_inc(i)
            for k in range(p.join_size):
                if not jvalid[i, k]:
                    continue
                t = int(jorder[i, k])
                ja.setdefault(t, []).append(
                    {
                        "address": self.addresses[i],
                        "status": Status.alive,
                        "incarnationNumber": own_inc,
                        "source": self.addresses[i],
                        "sourceIncarnationNumber": own_inc,
                    }
                )
        for t, ups in ja.items():
            self._apply(t, ups, tick_next)

        advertised = self.checksum.copy()
        # sender self-incarnation at ping-build time (rides in the ping
        # body) — the phase-5/6 origin filters compare against this, not
        # the post-receive value (engine: sent_self_inc)
        diag_inc_sent = np.array(
            [self._self_inc(i) for i in range(n)], np.int64
        )

        # ---- phase 2: target selection ----------------------------------
        known1, status1, inc1 = self._views()
        participating = self.proc_alive & self.ready & self.gossip_on
        pingable = (
            known1 & ((status1 == engine.ALIVE) | (status1 == engine.SUSPECT)) & ~eye
        )
        k_arange = np.arange(n)[None, :]
        pos = (self.iter_pos[:, None] + k_arange) % n
        cand = np.take_along_axis(self.perm, pos, axis=1)
        cand_pingable = np.take_along_axis(pingable, cand, axis=1)
        first_k = np.argmax(cand_pingable, axis=1).astype(np.int32)
        has_target = cand_pingable.any(axis=1)
        target = np.take_along_axis(cand, first_k[:, None], axis=1)[:, 0]
        target = np.where(participating & has_target, target, -1)
        wrapped = (self.iter_pos + first_k) >= n
        self.iter_pos = np.where(
            participating & has_target,
            (self.iter_pos + first_k + 1) % n,
            self.iter_pos,
        )
        resh = wrapped & participating
        if resh.any():  # engine skips the draw on wrap-free ticks too
            # affine re-indexing of a hashed base permutation — mirrors
            # engine._reshuffled bitwise (same f32 uniforms, same int math)
            base = np.argsort(
                _np_uniform(self.rng, (n,), salt=77), kind="stable"
            ).astype(np.int32)
            r = _np_uniform(self.rng, (n, 2), salt=7)
            cops, _ = engine._coprimes_of(n)
            k_cop = np.int32(len(cops))
            a = cops[
                np.clip((r[:, 0] * k_cop).astype(np.int32), 0, k_cop - 1)
            ]
            b = (r[:, 1] * np.float32(n)).astype(np.int32) % n
            idx = (
                a[:, None] * np.arange(n, dtype=np.int32) + b[:, None]
            ) % n
            new_perm = base[idx]
            self.perm = np.where(resh[:, None], new_perm, self.perm)
        valid_send = target >= 0

        # ---- phase 3: sender piggyback bump (issueAsSender) -------------
        server_count = (
            known1 & ((status1 == engine.ALIVE) | (status1 == engine.SUSPECT))
        ).sum(axis=1)
        max_pb = np.array(
            [p.piggyback_factor * _digits(int(c)) for c in server_count], np.int32
        )
        sendable: List[Dict[int, _Change]] = [dict() for _ in range(n)]
        for i in np.flatnonzero(valid_send):
            node = self.nodes[i]
            for j in list(node.changes.keys()):
                ch = node.changes[j]
                ch.pb += 1
                if ch.pb > max_pb[i]:
                    del node.changes[j]
                else:
                    sendable[i][j] = dataclasses.replace(ch)

        # ---- phase 4: delivery ------------------------------------------
        loss = _np_uniform(self.rng, (n,), salt=13) < p.packet_loss
        tgt = np.clip(target, 0, n - 1)
        tgt_ok = np.where(valid_send, self.proc_alive[tgt], False)
        conn_t = np.where(valid_send, self.partition == self.partition[tgt], False)
        delivered = valid_send & tgt_ok & conn_t & ~loss

        # ---- phase 5: receivers apply (winner-combine per subject) ------
        inbox: Dict[int, Dict[int, tuple]] = {}  # recv -> subject -> (key, s, ch)
        for s in np.flatnonzero(delivered):
            r = int(target[s])
            box = inbox.setdefault(r, {})
            for j, ch in sendable[s].items():
                key = ch.inc * 4 + ch.status
                cur = box.get(j)
                if cur is None or key > cur[0] or (key == cur[0] and s < cur[1]):
                    box[j] = (key, int(s), ch)
        for r, box in inbox.items():
            ups = [
                {
                    "address": self.addresses[j],
                    "status": STATUS_STR[ch.status],
                    "incarnationNumber": ch.inc,
                    "source": self.addresses[ch.source] if ch.source >= 0 else None,
                    "sourceIncarnationNumber": ch.source_inc,
                }
                for j, (_, _, ch) in sorted(box.items())
            ]
            self._apply(r, ups, tick_next)

        # receiver-side piggyback bump: one issueAsReceiver per ping, with
        # the receiver-origin filter applied BEFORE the bump (dissemination
        # .js:147-160) — the originating sender's own ping doesn't bump
        diag_inc_post5 = np.array([self._self_inc(i) for i in range(n)], np.int64)
        nrecv = np.zeros(n, np.int64)
        for s in np.flatnonzero(delivered):
            nrecv[target[s]] += 1
        respondable: List[Dict[int, _Change]] = [dict() for _ in range(n)]
        for r in np.flatnonzero(nrecv > 0):
            node = self.nodes[r]
            for j in list(node.changes.keys()):
                ch = node.changes[j]
                origin_hit = (
                    ch.source >= 0
                    and delivered[ch.source]
                    and target[ch.source] == r
                    and ch.source_inc == diag_inc_sent[ch.source]
                )
                ch.pb += int(nrecv[r]) - int(origin_hit)
                if ch.pb > max_pb[r]:
                    del node.changes[j]
                else:
                    respondable[r][j] = dataclasses.replace(ch)

        mid_checksum = self._compute_checksums()

        # ---- phase 6: responses + full-sync -----------------------------
        # the engine applies every sender's response in ONE batched update;
        # payloads must therefore come from the phase-6-start snapshot, not
        # from state mutated by an earlier sender's application
        known5, status5, inc5 = self._views()
        full_syncs = 0
        for s in np.flatnonzero(delivered):
            t = int(target[s])
            # drop changes the pinging sender originated
            # (dissemination.js:91-98; engine resp_filter)
            resp = {
                j: ch
                for j, ch in respondable[t].items()
                if not (ch.source == s and ch.source_inc == diag_inc_sent[s])
            }
            if resp:
                ups = [
                    {
                        "address": self.addresses[j],
                        "status": STATUS_STR[ch.status],
                        "incarnationNumber": ch.inc,
                        "source": self.addresses[ch.source]
                        if ch.source >= 0
                        else None,
                        "sourceIncarnationNumber": ch.source_inc,
                    }
                    for j, ch in sorted(resp.items())
                ]
                self._apply(s, ups, tick_next)
            elif mid_checksum[t] != advertised[s]:
                # full sync (dissemination.js:101-114) — target's snapshot view
                full_syncs += 1
                ups = [
                    {
                        "address": self.addresses[j],
                        "status": STATUS_STR[status5[t, j]],
                        "incarnationNumber": int(inc5[t, j]),
                        "source": self.addresses[t],
                        "sourceIncarnationNumber": int(diag_inc_post5[t]),
                    }
                    for j in np.flatnonzero(known5[t])
                ]
                self._apply(s, ups, tick_next)

        # ---- phase 7: ping-req ------------------------------------------
        # carries dissemination both ways, mirroring engine phase 7: the
        # probing sender piggybacks issueAsSender on each body
        # (ping-req-sender.js:74-79), intermediaries apply and answer
        # issueAsReceiver (origin filter, bump, full-sync —
        # server/protocol/ping-req.js:46,62-66), the sender applies the
        # responses, THEN judges reachability (ping-req-sender.js:132-139,
        # 249-262).  Same envelope as the engine: the relay ping to the
        # target is reachability-only.
        K_pr = p.ping_req_size
        need_pr = valid_send & ~delivered
        pr_rand = _np_uniform(self.rng, (n, n), salt=29)
        pr_ok = pingable & (np.arange(n)[None, :] != target[:, None]) & need_pr[:, None]
        pr_score = np.where(pr_ok, pr_rand, np.float32(2.0))
        pr_sel = np.argsort(pr_score, axis=1, kind="stable")[:, :K_pr]
        pr_valid = np.take_along_axis(pr_score, pr_sel, axis=1) < 1.5
        m_alive = self.proc_alive[pr_sel]
        m_conn = self.partition[pr_sel] == self.partition[:, None]
        loss1 = _np_uniform(self.rng, (n, K_pr), salt=31) < p.packet_loss
        responder = pr_valid & m_alive & m_conn & ~loss1
        t_alive = np.where(need_pr, self.proc_alive[tgt], False)
        t_conn = self.partition[pr_sel] == self.partition[tgt][:, None]
        loss2 = _np_uniform(self.rng, (n, K_pr), salt=37) < p.packet_loss
        reached = responder & t_alive[:, None] & t_conn & ~loss2
        mark_suspect = need_pr & responder.any(axis=1) & ~reached.any(axis=1)

        # body sourceIncarnationNumber: read at build time, post-phase-6
        pr_self_inc = np.array(
            [self._self_inc(i) for i in range(n)], np.int64
        )

        # leg 1: issueAsSender per valid slot, sequentially (each slot
        # bumps every still-active change, reachable intermediary or not)
        pr_bodies: Dict[tuple, Dict[int, _Change]] = {}
        for i in np.flatnonzero(need_pr):
            node_i = self.nodes[i]
            for k in range(K_pr):
                if not pr_valid[i, k]:
                    continue
                body: Dict[int, _Change] = {}
                for j in list(node_i.changes.keys()):
                    ch = node_i.changes[j]
                    ch.pb += 1
                    if ch.pb > max_pb[i]:
                        del node_i.changes[j]
                    else:
                        body[j] = dataclasses.replace(ch)
                pr_bodies[(int(i), k)] = body

        # leg 2: intermediaries apply (winner-combine per subject; ties
        # keep the lowest (sender, slot) pair — engine flat-id order)
        inbox_pr: Dict[int, Dict[int, tuple]] = {}
        for i in np.flatnonzero(need_pr):
            for k in range(K_pr):
                if not responder[i, k]:
                    continue
                m = int(pr_sel[i, k])
                box = inbox_pr.setdefault(m, {})
                flat = int(i) * K_pr + k
                for j, ch in pr_bodies[(int(i), k)].items():
                    key = ch.inc * 4 + ch.status
                    cur = box.get(j)
                    if cur is None or key > cur[0] or (
                        key == cur[0] and flat < cur[1]
                    ):
                        box[j] = (key, flat, ch)
        for m, box in sorted(inbox_pr.items()):
            ups = [
                {
                    "address": self.addresses[j],
                    "status": STATUS_STR[ch.status],
                    "incarnationNumber": ch.inc,
                    "source": self.addresses[ch.source] if ch.source >= 0 else None,
                    "sourceIncarnationNumber": ch.source_inc,
                }
                for j, (_, _, ch) in sorted(box.items())
            ]
            self._apply(m, ups, tick_next)

        # full-sync decisions use MID-TICK checksums on both sides — the
        # engine's serialization choice (a fresh post-leg-2 recompute
        # would be a third encode per tick; see engine phase 7's note)

        # leg 3a: receiver bumps on the intermediary (issueAsReceiver per
        # arriving ping-req, origin filter before the bump; aggregated
        # like the ping path's phase 5.5)
        prrecv = np.zeros(n, np.int64)
        cnt_sm = np.zeros((n, n), np.int64)
        for i in np.flatnonzero(need_pr):
            for k in range(K_pr):
                if responder[i, k]:
                    m = int(pr_sel[i, k])
                    prrecv[m] += 1
                    cnt_sm[m, i] += 1
        pr_respondable: List[Dict[int, _Change]] = [dict() for _ in range(n)]
        for m in np.flatnonzero(prrecv > 0):
            node_m = self.nodes[m]
            for j in list(node_m.changes.keys()):
                ch = node_m.changes[j]
                hits = 0
                if ch.source >= 0 and ch.source_inc == pr_self_inc[ch.source]:
                    hits = int(cnt_sm[m, ch.source])
                ch.pb += int(prrecv[m]) - hits
                if ch.pb > max_pb[m]:
                    del node_m.changes[j]
                else:
                    pr_respondable[m][j] = dataclasses.replace(ch)

        # leg 3b: responses, winner-combined at the sender (max key; ties
        # keep the lowest slot).  Payloads come from the post-leg-2
        # snapshot, exactly like the engine builds every slot's content
        # before one batched apply.
        known7, status7, inc7 = self._views()
        diag_inc_7 = np.array(
            [self._self_inc(i) for i in range(n)], np.int64
        )
        pr_fs = 0
        for i in np.flatnonzero(need_pr):
            best: Dict[int, tuple] = {}
            for k in range(K_pr):
                if not responder[i, k]:
                    continue
                m = int(pr_sel[i, k])
                resp = {
                    j: ch
                    for j, ch in pr_respondable[m].items()
                    if not (
                        ch.source == i and ch.source_inc == pr_self_inc[i]
                    )
                }
                if resp:
                    content = [
                        (
                            j,
                            ch.inc * 4 + ch.status,
                            {
                                "address": self.addresses[j],
                                "status": STATUS_STR[ch.status],
                                "incarnationNumber": ch.inc,
                                "source": self.addresses[ch.source]
                                if ch.source >= 0
                                else None,
                                "sourceIncarnationNumber": ch.source_inc,
                            },
                        )
                        for j, ch in resp.items()
                    ]
                elif mid_checksum[m] != mid_checksum[i]:
                    pr_fs += 1
                    content = [
                        (
                            j,
                            int(inc7[m, j]) * 4 + int(status7[m, j]),
                            {
                                "address": self.addresses[j],
                                "status": STATUS_STR[status7[m, j]],
                                "incarnationNumber": int(inc7[m, j]),
                                "source": self.addresses[m],
                                "sourceIncarnationNumber": int(diag_inc_7[m]),
                            },
                        )
                        for j in np.flatnonzero(known7[m])
                    ]
                else:
                    content = []
                for j, key, upd in content:
                    cur = best.get(j)
                    if cur is None or key > cur[0]:
                        best[j] = (key, upd)
            if best:
                self._apply(
                    i,
                    [upd for j, (_, upd) in sorted(best.items())],
                    tick_next,
                )

        # suspect verdict on post-response state (reference: makeSuspect
        # after every ping-req callback applied its changes)
        for i in np.flatnonzero(mark_suspect):
            t = int(tgt[i])
            m = self.nodes[i].membership.find_member_by_address(self.addresses[t])
            cur_inc = m.incarnation_number if m is not None else 0
            self._apply(
                i,
                [
                    {
                        "address": self.addresses[t],
                        "status": Status.suspect,
                        "incarnationNumber": cur_inc,
                        "source": self.addresses[i],
                        "sourceIncarnationNumber": int(self._self_inc(i)),
                    }
                ],
                tick_next,
            )
        full_syncs += pr_fs

        # ---- phase 8: suspicion expiry ----------------------------------
        for i in range(n):
            if not participating[i]:
                continue
            node = self.nodes[i]
            due = [j for j, dl in node.susp.items() if 0 <= dl <= tick_next]
            if not due:
                continue
            ups = []
            for j in sorted(due):
                node.susp.pop(j, None)
                m = node.membership.find_member_by_address(self.addresses[j])
                cur_inc = m.incarnation_number if m is not None else 0
                ups.append(
                    {
                        "address": self.addresses[j],
                        "status": Status.faulty,
                        "incarnationNumber": cur_inc,
                        "source": self.addresses[i],
                        "sourceIncarnationNumber": int(diag_inc_post5[i]),
                    }
                )
            self._apply(i, ups, tick_next)

        # ---- phase 9: checksums -----------------------------------------
        self.checksum = self._compute_checksums()
        part = self.proc_alive & self.ready
        live_cs = self.checksum[part]
        distinct = len(set(live_cs.tolist())) if live_cs.size else 0

        self.rng = _np_fold(self.rng, 0x5EED)
        return OracleTickResult(
            checksums=self.checksum.copy(),
            converged=distinct <= 1,
            distinct_checksums=distinct,
            full_syncs=full_syncs,
            pings_sent=int(valid_send.sum()),
        )
