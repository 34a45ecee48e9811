"""Hand-written CUDA kernels of the port (sm_90a), one per Pallas kernel on
the serving path, each beside its plain PyTorch version (``ref``):

  exit_confidence   — fused (top-1 softmax prob, argmax) LM head
  decode_attention  — flash-decode of one query token against a KV cache

``ops`` dispatches between them; ``build`` compiles ``csrc/*.cu`` at first
use.  ``paged_decode_attention`` and ``flash_attention`` are not ported yet
(ROADMAP).
"""
