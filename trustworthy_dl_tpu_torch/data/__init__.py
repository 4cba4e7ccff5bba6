"""Language-model and vision data loaders (``loader``)."""

from trustworthy_dl_tpu_torch.data.loader import get_dataloader  # noqa: F401
