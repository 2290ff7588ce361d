"""Quantizer core: levels, statistics, adaptation, packing and the codec.

The reference's public names, all of which the port has.  The functions
that round take their uniforms as an explicit ``u``, and ``merge_stats``
takes the workers' mixtures stacked (there is no named axis).
"""
from .levels import (
    exp_levels,
    is_feasible,
    level_gaps,
    multiplier_to_levels,
    num_inner,
    num_levels,
    ternary_levels,
    uniform_levels,
)
from .quantize import (
    NORM_L1,
    NORM_L2,
    NORM_LINF,
    QuantizedTensor,
    bucket_norm,
    code_dtype,
    decode,
    encode,
    normalized_magnitudes,
    pad_to_buckets,
    quantization_variance,
    quantize,
    stochastic_round,
)
from .stats import (
    TruncNormStats,
    expected_variance,
    fit_bucket_stats,
    merge_stats,
    stats_from_moments,
    mixture_cdf,
    mixture_inverse_cdf,
    mixture_pdf,
    partial_moment0,
    partial_moment1,
    partial_moment2,
)
from .adapt import (
    alq_gd_update,
    alq_update,
    amq_gradient,
    amq_objective,
    amq_update,
    psi_gradient,
)
from .codec import (
    EntropyCodec,
    GradientCodec,
    MixedWidthCodec,
    UniformCodec,
    WirePayload,
    WirePlan,
    assign_mixed_widths,
    codec_for_scheme,
    entropy_codec_for_scheme,
    entropy_codec_from_gradient,
    entropy_wrap,
    make_codec,
    mixed_widths_from_gradient,
    requant_codec,
    resample_levels,
)
from .coding import (
    canonical_code,
    code_length_bound,
    entropy_bits,
    entropy_table,
    expected_bits_per_coordinate,
    expected_huffman_bits,
    huffman_code_lengths,
    level_probabilities,
    signed_symbol_probabilities,
)
from .packing import (
    norm_words,
    pack,
    pack_norms,
    pack_signed,
    packed_words,
    unpack,
    unpack_norms,
    unpack_signed,
    wire_bits_for,
)
from .schemes import (
    ALL_SCHEMES,
    QuantScheme,
    SchemeState,
    default_update_schedule,
)
