"""The LM scaffold's models: dense attention, SSD (Mamba-2) and the VLM
prefix over one decoder stack (part 1 of the port of ``repro.models``)."""

#: What the families that are not ported yet raise with.
PART2 = ("not ported yet: MoE, MLA, multi-token prediction, RG-LRU and "
         "the encoder-decoder belong to the LM scaffold, part 2")
