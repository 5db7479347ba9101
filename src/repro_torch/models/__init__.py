"""Decoder LM (port of `repro.models`, the dense GQA subset): modules,
attention through the flash kernel, transformer prefill/decode, and the
prefill/decode step builders."""
