"""The LM scaffold's models: dense attention, MLA, MoE, RG-LRU, SSD
(Mamba-2), the VLM prefix and the encoder-decoder (the port of
``repro.models``)."""
