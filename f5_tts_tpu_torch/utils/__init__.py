"""Host and tensor utilities: the masks (`masks`), the tokenizer
(`tokenizer`), the sampler's noise and time grid (`sampling`), shared layer
pieces (`modules`), the safetensors reader and writer (`safetensors`) and
the snapshot hub (`hub`)."""

from f5_tts_tpu_torch.utils.masks import (
    lens_to_mask,
    mask_from_frac_lengths,
    mask_from_start_end_indices,
    maybe_masked_mean,
    pad_sequence,
    pad_to_length,
)
from f5_tts_tpu_torch.utils.tokenizer import convert_char_to_pinyin, list_str_to_idx, list_str_to_tensor, load_vocab

__all__ = [
    "convert_char_to_pinyin",
    "lens_to_mask",
    "list_str_to_idx",
    "list_str_to_tensor",
    "load_vocab",
    "mask_from_frac_lengths",
    "mask_from_start_end_indices",
    "maybe_masked_mean",
    "pad_sequence",
    "pad_to_length",
]
