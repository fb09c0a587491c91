"""The text modality (``rmm_tpu/nn/text``): the hashing embedder of the
frozen path, the hashing tokenizer and the from-scratch LM of the finetune
path (LoRA on its output projection). The pretrained LMs are not ported:
``get_text_embedder`` refuses any model but ``hashing``."""
from .embedder import HashingTextEmbedder, get_text_embedder  # noqa: F401
from .finetune import (PAD_ID, Embed, HashingTokenizer,  # noqa: F401
                       TextToEmbeddingFinetune)
from .lora import LoRADense  # noqa: F401
