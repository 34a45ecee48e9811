"""Hand-written CUDA kernels of the port (sm_90a), one per Pallas kernel on
the serving path, each beside its plain PyTorch version (``ref``):

  exit_confidence         — fused (top-1 softmax prob, argmax) LM head
  decode_attention        — flash-decode of one query token against a KV cache
  paged_decode_attention  — the same through a block table over a paged pool

``ops`` dispatches between them; ``build`` compiles ``csrc/*.cu`` at first
use.  ``flash_attention`` is not ported yet (ROADMAP).
"""
