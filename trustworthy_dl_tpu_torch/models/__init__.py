"""GPT-2 (dense and Mixture-of-Experts), ResNet and VGG, the weight
converter and the cached/paged generation paths.  The names below resolve
at first access (``_lazy``)."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "models.factory": ("ModelBundle", "ModelFactory", "create_model",
                       "get_model"),
})
