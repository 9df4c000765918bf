"""nano_orc — GPU-native nanopore amplicon barcoding engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
srisarya/nanopore-barcoding-ORC pipeline: read reorientation
(pychopper-equivalent), dual-index demultiplexing with
cutadapt-equivalent semantics, all-vs-all edit-distance clustering +
consensus (amplicon_sorter-equivalent), linked-primer cleanup, and
18S/28S rRNA extraction — batched on an NVIDIA GPU, data-parallel over
device meshes.

Layering (see SURVEY.md §7):
    io/       FASTQ/FASTA parsing, base encoding, batching
    align/    alignment semantics: CPU oracle + batched JAX + Pallas kernel
    native/   C++ CPU oracle (parity + host-side consensus hot paths)
    demux/    reorientation, dual-round demux, primer cleanup
    cluster/  all-vs-all clustering + consensus ladder
    rrna/     profile-HMM 18S/28S extraction
    dist/     mesh setup + shard_map data parallelism
    pipeline/ stage graph + reports
    device.py the device route of each operation
    synth.py  seeded adapter banks and synthetic read sets
"""

import os as _os

__version__ = "0.1.0"


def _use_checkout_compile_cache() -> None:
    """JAX's persistent compilation cache lives where
    JAX_COMPILATION_CACHE_DIR says; when it is unset, in <checkout>/.jax_cache.
    Set through jax.config, so it holds whenever jax was imported."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", _os.path.normpath(
        _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "..",
                      ".jax_cache")))


_use_checkout_compile_cache()
