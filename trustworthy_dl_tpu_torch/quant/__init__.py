"""Quantization tiers of the serving engine (counterpart of
``trustworthy_dl_tpu/quant``)."""
