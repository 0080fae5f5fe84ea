"""The LM side of the port: parameter specs, the dense transformer and the
unified model API (``api``).  Mirrors ``repro.models`` for the dense
family; MoE, SSM, hybrid, encoder-decoder and VLM families are ROADMAP
Queue 1 item 7."""
