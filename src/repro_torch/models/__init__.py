"""The LM substrate of the port: dense decoder-only transformers whose
blocks are ``attn`` or ``attn_local`` (qwen2, qwen3, gemma3), for the
conformal OOD serving path (``core/lm_conformal.py``).

* ``common`` — init, norms, RoPE, activations;
* ``attention`` — GQA attention, full sequence (the ``flash_attention``
  kernel) and one-token decode against a KV cache;
* ``mlp`` — the gated MLP (SwiGLU / GeGLU);
* ``blocks`` — block assembly, runs of layers and their caches;
* ``lm`` — embedding, the layer stack, the tied head, decode.
"""
