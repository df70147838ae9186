"""The LM substrate of the port: the ten architectures of
``configs.ARCH_NAMES``, for the conformal OOD serving path
(``core/lm_conformal.py``) and for training (``runtime/``).

* ``common`` — init, norms, RoPE, activations;
* ``attention`` — GQA and MLA attention, full sequence (the
  ``flash_attention`` kernel) and one-token decode against a KV cache;
* ``mlp`` — the gated MLP (SwiGLU / GeGLU) and the token-choice MoE;
* ``recurrent`` — the RG-LRU, mLSTM and sLSTM blocks;
* ``blocks`` — block assembly, runs of layers and their caches, remat;
* ``boundary`` — the trainer's bf16 cotangent rounding at block inputs;
* ``lm`` — embedding, the layer stack, the tied head, decode, the
  encoder-decoder, the training loss.
"""
