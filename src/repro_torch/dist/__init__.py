"""Distributed communication engine: quantized collectives and FSDP.

``sync``      ENCODE -> collective -> DECODE (Algorithm 1, lines 6-9) in
              the packed wire modes, the sufficient-statistics gather and
              the schedule-gated level update.
``fsdp``      The flat-parameter substrate: per-slot flatten metadata,
              chunk planning, and the all-gather forward / quantized
              reduce-scatter backward.
``transport`` The collective transports the wire modes run on: stacked
              workers on one device (the simulator's masked ones too) or
              one worker a process over a ``torch.distributed`` group.
``faults``    Wire-fault injection around a transport.

The codec's public names are re-exported, as the reference's are: the
codec is the wire contract of this package.  ``StackedTransport`` stands
for the reference's ``Transport`` base and ``ProcessGroupTransport`` for
its ``MeshTransport``.
"""
from . import faults, fsdp, sync, transport  # noqa: F401
from repro_torch.core.codec import (  # noqa: F401
    GradientCodec,
    MixedWidthCodec,
    UniformCodec,
    WirePayload,
    WirePlan,
    assign_mixed_widths,
    codec_for_scheme,
    make_codec,
    mixed_widths_from_gradient,
    requant_codec,
)
from .sync import (  # noqa: F401
    SyncMetrics,
    gather_stats,
    maybe_update_levels,
    quantized_allreduce,
)
from .faults import (  # noqa: F401
    FaultModel,
    FaultyTransport,
    faulty,
)
from .transport import (  # noqa: F401
    MaskedTransport,
    ProcessGroupTransport,
    StackedTransport,
    make_transport,
)
