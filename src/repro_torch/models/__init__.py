"""The LM side of the port: parameter specs, the transformer (dense, moe
and vlm families), the MoE FFN, the Mamba-2 SSD mixer and LM, the hybrid
(Jamba) LM and the unified model API (``api``).  Mirrors
``repro.models``; the encoder-decoder family and expert parallelism are
ROADMAP Queue 1 item 7."""
