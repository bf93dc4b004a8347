"""asciichat_tpu_torch — the render path, the audio mixer and the live
server of asciichat_tpu in PyTorch, with hand-written CUDA kernels for an
NVIDIA H100 (``sm_90a``).

The JAX package ``asciichat_tpu`` stays beside it as the reference. This
package imports ``torch`` and never ``jax``, and nothing of ``asciichat_tpu``:
it runs where that package is absent. The host modules it needs (the oracle,
the emitter, palettes, geometry, options, frame sources and codecs, the
session display, the ACIP packet, transport and crypto layers) are its own
copies, under the JAX package's relative paths (``render/``, ``utils/``,
``runtime/``, ``net/``, ``models/session.py``); the C++ runtime in the
repository's ``native/`` is built into the port's own build directory.

- ``ops/``: plain PyTorch versions of the per-pixel math and the kernels'
  wrappers: K1 resize (``ops/resize.py``), K2 cell records (``ops/cells.py``),
  K4 the exclude-self audio mixer (``ops/audio.py``).
- ``models/server.py``: the server tick, K3 (render) and K4 (mix).
- ``render/pipeline.py``: mirror convert, frames -> byte-exact ANSI.
- ``apps/``: the command line (``mirror``, ``server``) and the asyncio
  server (``apps/server.py``).
- ``render/oracle.py``: the reference's scalar renderer, the byte judge.
- ``csrc/``: the CUDA sources, built with nvcc at first use
  (``runtime/kernel_build.py``).

A tensor on the CPU takes each kernel's plain version; a tensor on a CUDA
device launches the kernel or raises.
"""

__version__ = "0.1.0"
