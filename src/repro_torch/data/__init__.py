"""The LM data plane.  The tokenizer is ported; the stream packer
(``repro.data.packing``) is ROADMAP Queue 1 item 9."""
from repro_torch.data.tokenizer import HashTokenizer  # noqa: F401
