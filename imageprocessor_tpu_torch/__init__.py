"""imageprocessor_tpu_torch — the PyTorch/CUDA port of imageprocessor_tpu.

The JAX package beside it is the reference; this package serves the same
main path on an NVIDIA Hopper card (sm_90a) without importing jax or the
reference package:

* host: the streaming entropy scan of ``native/jpeg_scan.cpp`` fills
  int16 coefficient canvases (``runtime/hostcodec.py``);
* device kernel B1 (``csrc/jpeg_decode.cu``): coefficients -> planar u8
  RGB, the port of ``ops/pallas_jpeg.py``'s fused decode;
* device kernel B2 (``csrc/fused_resample.cu``): one launch writes both
  the keep-aspect resize and the thumbnail, the port of
  ``ops/pallas_fused.py``;
* host: the two small outputs are encoded (``runtime/codecs.py``, OpenCV)
  and saved.

Layout mirrors the reference (``ops/``, ``models/``, ``runtime/``). The
jax-free modules the port shares with it (``domain``, ``errors``,
``broker``, ``storage``, ``utils.metrics``, ``runtime/batcher.py``,
``runtime/codecs.py``, ``models/plan.py``, ``runtime/paths.py``) are
copies, held equal to the originals by tests until ROADMAP A.17. Each
kernel has a plain PyTorch version beside it; a wrapper takes the plain
version only for tensors on the CPU and launches the kernel (or raises)
for CUDA tensors. Nothing is built or launched at import time.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
