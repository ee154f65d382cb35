"""Typed error catalog.

Mirrors ringpop-node lib/errors.js:22-87 — each error carries a dotted
``type`` identifier (``ringpop.*``) and a formatted message, so control-plane
responses can discriminate on error type exactly like the reference's
TypedError instances.
"""

from __future__ import annotations

from typing import Any, Dict


class RingpopError(Exception):
    type: str = "ringpop.error"
    template: str = "ringpop error"

    def __init__(self, **fields: Any) -> None:
        self.fields: Dict[str, Any] = fields
        try:
            message = self.template.format(**fields)
        except (KeyError, IndexError):
            message = self.template
        super().__init__(message)

    def to_dict(self) -> Dict[str, Any]:
        out = {"type": self.type, "message": str(self), **self.fields}
        status = getattr(self, "status_code", None)
        if status is not None:
            # the reference's sendError maps err.statusCode onto the HTTP
            # response (request-proxy/index.js sendError: statusCode || 500)
            out["statusCode"] = status
        return out


class AppRequiredError(RingpopError):
    type = "ringpop.options-app.required"
    template = (
        "Expected `options.app` to be a non-empty string. Are you sure you "
        "specified an app?"
    )


class HostPortRequiredError(RingpopError):
    type = "ringpop.options-host-port.required"
    template = (
        "Expected `options.hostPort` to be valid. Got {hostPort} which is not "
        "{reason}."
    )


class ArgumentRequiredError(RingpopError):
    type = "ringpop.argument-required"
    template = "Expected `{argument}` to be provided"


class ChannelRequiredError(RingpopError):
    type = "ringpop.options-channel.required"
    template = "Expected `options.channel` to be provided"


class ChannelDestroyedError(RingpopError):
    type = "ringpop.options-channel.destroyed"
    template = "Expected `options.channel` to not be destroyed"


class DuplicateHookError(RingpopError):
    type = "ringpop.duplicate-hook"
    template = "Expected hook name '{name}' to not already be registered"


class InvalidJoinAppError(RingpopError):
    type = "ringpop.invalid-join.app"
    template = (
        "A node tried joining a different app cluster. The expected app "
        "({expected}) did not match the actual app ({actual})"
    )


class InvalidJoinSourceError(RingpopError):
    type = "ringpop.invalid-join.source"
    template = (
        "A node tried joining a cluster by attempting to join itself. The "
        "joiner ({actual}) must join someone else."
    )


class InvalidLocalMemberError(RingpopError):
    type = "ringpop.invalid-local-member"
    template = "Operation requires a valid local member"


class LookupKeyRequiredError(RingpopError):
    type = "ringpop.lookup.key-required"
    template = "Lookup requires a key"


class PingReqTargetUnreachableError(RingpopError):
    type = "ringpop.ping-req.target-unreachable"
    template = "Ping-req target is unreachable"


class PingReqInconclusiveError(RingpopError):
    type = "ringpop.ping-req.inconclusive"
    template = "Ping-req was inconclusive"


class DenyJoinError(RingpopError):
    type = "ringpop.deny-join"
    template = "Node is currently configured to deny joins"


class BlacklistedError(RingpopError):
    type = "ringpop.invalid-join.blacklist"
    template = "Node ({member}) is blacklisted and cannot join"


class InvalidCheckSumError(RingpopError):
    type = "ringpop.request-proxy.invalid-checksum"
    template = (
        "Expected the remote checksum to match local checksum. The "
        "expected checksum ({expected}) did not match actual checksum "
        "({actual})."
    )


class MaxRetriesExceededError(RingpopError):
    type = "ringpop.request-proxy.max-retries-exceeded"
    template = "Max number of retries exceeded. {maxRetries} retries attempted."


class KeysDivergedError(RingpopError):
    type = "ringpop.request-proxy.keys-diverged"
    template = (
        "Destinations for proxied request have diverged. These keys ({keys}) "
        "were originally intended for {origDestination}, but are now destined "
        "for these hosts ({newDestinations})."
    )


class RequestProxyDestroyedError(RingpopError):
    type = "ringpop.request-proxy.destroyed"
    template = "Request proxy was destroyed before it could proxy your request"


class BodyLimitExceededError(RingpopError):
    """The node `body` module's limit error: the reference forwards request
    bodies through body(req, res, {limit: opts.bodyLimit}, ...)
    (lib/request-proxy/index.js:88-90) and an oversized body fails the
    forward with a 413 'request entity too large'."""

    type = "ringpop.request-proxy.body-limit"
    template = "request entity too large (limit {limit}, got {length})"
    status_code = 413


class RedundantLeaveError(RingpopError):
    type = "ringpop.invalid-leave.redundant"
    template = "A node cannot leave its cluster when it has already left."


class InvalidJoinRetriesError(RingpopError):
    type = "ringpop.join-aborted"
    template = "Join aborted: {reason}"


class PropertyRequiredError(RingpopError):
    type = "ringpop.property-required"
    template = "Expected `{property}` to be defined"


class SimShapeError(RingpopError):
    """New-capability error: the batched simulator rejects incompatible shapes."""

    type = "ringpop.sim.shape-mismatch"
    template = "Simulator state shape mismatch: {reason}"
