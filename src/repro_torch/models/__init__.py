"""The LM side (port of `repro.models`): modules, attention through the
flash kernel, MoE, SSD and RG-LRU layers, transformer prefill/decode for
every layer kind and frontend, and the prefill/decode step builders."""
