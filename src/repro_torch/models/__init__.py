"""The LM side of the port: parameter specs, the transformer (dense, moe
and vlm families), the MoE FFN, the Mamba-2 SSD mixer and LM, the hybrid
(Jamba) LM, the encoder-decoder (whisper) LM and the unified model API
(``api``), expert parallelism over a device mesh (``moe_ep``) and the
logical-axis sharding rules (``sharding``).  Mirrors ``repro.models``."""
