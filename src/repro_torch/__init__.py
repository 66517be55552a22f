"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s module layout so each module's counterpart is found by
name.  It imports ``torch`` and never ``jax`` or ``repro``: the
framework-free modules it needs (configs, obs, core planning) are its own
copies.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
