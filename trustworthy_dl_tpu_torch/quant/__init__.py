"""Quantization tiers of the serving engine (counterpart of
``trustworthy_dl_tpu/quant``).  The names below resolve at first access
(``_lazy``)."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "quant.int8": ("KV_DTYPES", "PARITY_MARGIN_TOL", "QMAX", "WEIGHT_DTYPES",
                   "dequantize_int8", "draft_decode_view",
                   "is_quantized_dense", "kv_parity_probe", "qdense",
                   "quantize_decode_view", "quantize_dense",
                   "quantize_int8", "quantize_kv", "resolve_kv_dtype",
                   "validate_dtypes", "weight_roundtrip_errors"),
})
