"""torchgate: the port's static analysis of the port (``ringpop_tpu_torch/``).

Counterpart of ``ringpop_tpu/analysis/``.  The prongs are registered in
:mod:`ringpop_tpu_torch.analysis.prongs`, the one source the CLI, ``--prong
all`` and the README's port prong table derive from:

- :mod:`.astlint` (``ast``): rules over the source, in torch idiom;
- :mod:`.graph_audit` (``graph``): the recorded ops of every registered
  entry point (host reads against each entry's declared count, the int32
  hash path's dtypes), over the op recorder of :mod:`.dataflow`;
- :mod:`.kernel_coverage` (``kernels``): every CUDA kernel has a
  ``TWIN_REGISTRY`` row, live entries and gate tests;
- :mod:`.noninterference` (``noninterference``): no obs-only input field
  reaches a trajectory output field;
- :mod:`.overflow` over :mod:`.ranges` (``overflow``): interval ranges
  over the recorded ops — dtype escapes, unbounded state carries, index
  lanes at the declared N;
- :mod:`.scale_budget` (``scale``), :mod:`.cost` (``cost``),
  :mod:`.donation` (``donation``, the aliasing surface) and
  :mod:`.retrace` (``retrace``): each against its manifest in
  ``analysis/budgets/`` (:mod:`.manifests`).

CLI: ``python -m ringpop_tpu_torch.analysis`` (see ``--help``).  Nothing
here imports JAX or the JAX package.
"""

from ringpop_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    render_json,
    render_text,
)
