"""Host-side text frontend: vocab tokenizer, chunking, pinyin conversion (the
port's own copy of `eraxvif5tts_tpu/text/`)."""

from eraxvif5tts_tpu_torch.text.chunk import chunk_text  # noqa: F401
from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin  # noqa: F401
from eraxvif5tts_tpu_torch.text.tokenizer import (  # noqa: F401
    get_tokenizer,
    list_str_to_bytes,
    list_str_to_idx,
)
