"""Hand-written CUDA kernels of the port (sm_90a), one per Pallas kernel of
the JAX package, each beside its plain PyTorch version (``ref``):

  flash_attention         — prefill attention, causal/window, GQA
  exit_confidence         — fused (top-1 softmax prob, argmax) LM head
  decode_attention        — flash-decode of one query token against a KV cache
  paged_decode_attention  — the same through a block table over a paged pool

``ops`` dispatches between them; ``build`` compiles ``csrc/*.cu`` at first
use.
"""
