"""Quantized storage of the port (counterpart of ``repro/quant``): per-block
symmetric int8 and nibble-packed int4 ``QArray`` weights, per-token int8
activation codes, the row-wise int8 codec of the KV cache and of recurrent
state (``pack_state_cache``), and the
``QuantConfig`` knob threaded through configs → engine → launcher."""

from repro_torch.quant.qarray import (  # noqa: F401
    QArray,
    QuantConfig,
    dequantize,
    dequantize_act,
    dequantize_rows,
    int_values,
    is_qarray,
    pack_state_cache,
    pack_int4,
    plane_order,
    quantize,
    quantize_act,
    quantize_rows,
    tree_is_quantized,
    tree_nbytes,
    unpack_int4,
    unpack_int4_planes,
    unpack_state_cache,
)
