"""Language-model and vision data loaders (``loader``) and the byte-level
BPE tokenizer with the ``.txt`` to ``.bin`` step (``tokenizer``)."""

from trustworthy_dl_tpu_torch.data.loader import ArrayDataLoader, \
    PrefetchLoader, TokenStreamLoader, get_dataloader
from trustworthy_dl_tpu_torch.data.tokenizer import BPETokenizer, \
    prepare_data, train_bpe

__all__ = ["ArrayDataLoader", "BPETokenizer", "PrefetchLoader",
           "TokenStreamLoader", "get_dataloader", "prepare_data",
           "train_bpe"]
