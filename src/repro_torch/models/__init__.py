"""The LM side of the port: parameter specs, the transformer (dense, moe
and vlm families), the MoE FFN, the Mamba-2 SSD mixer and LM, the hybrid
(Jamba) LM, the encoder-decoder (whisper) LM and the unified model API
(``api``).  Mirrors ``repro.models``; expert parallelism (``moe_ep``) is
ROADMAP Queue 1 item 7."""
