"""The device route of each operation.

The program runs on one of two JAX platforms. ``"gpu"`` (an NVIDIA card)
takes the device path of every operation; ``"cpu"`` takes the native/XLA
path the tests use. Any other platform is an error: nothing falls back
silently.

    operation           gpu                              cpu
    Myers scoring       align/myers_gpu.py (Pallas)      native C++
    multi-device Myers  align/myers_gpu.py per device    align/myers.py per device
    rRNA anchor Myers   align/myers_gpu.py               align/myers.py (XLA)
    dual-round demux    demux/fused.py (one XLA program) two unfused XLA rounds
    locate              align/batched.py (XLA)           align/batched.py (XLA)
"""
from __future__ import annotations

import jax

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The JAX default backend, checked against PLATFORMS."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: nano_orc runs on an NVIDIA "
            f"GPU ('gpu') or on the CPU ('cpu')")
    return p


def on_gpu() -> bool:
    return platform() == "gpu"


def myers_distances(pat_codes, m_lens, txt_codes, n_lens, mode="NW"):
    """([P, T] distances, [P, T] end positions) of every pattern against
    every text on the platform's Myers route."""
    if on_gpu():
        from .align import myers_gpu
        return myers_gpu.distances(pat_codes, m_lens, txt_codes, n_lens,
                                   mode)
    from .align import myers
    return myers.distances_with_pos(pat_codes, m_lens, txt_codes, n_lens,
                                    mode)
