"""The LM data plane: the hash tokenizer and the stream packer (copies of
``repro.data``)."""
from repro_torch.data.packing import StreamPacker, pack_stream  # noqa: F401
from repro_torch.data.tokenizer import HashTokenizer  # noqa: F401
