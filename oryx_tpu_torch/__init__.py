"""oryx_tpu_torch — the ALS serving path of ``oryx_tpu`` in PyTorch for
an NVIDIA H100.

Module paths mirror ``oryx_tpu/``, so each module's counterpart sits at
the same relative path there.  The package imports ``torch`` and
``numpy`` and nothing of JAX or of ``oryx_tpu``: what it needs from a
JAX-free module of the reference it keeps as its own copy.

Every entry point that places data takes ``device=None``, which means
``cuda``; without a CUDA device such a call raises unless the caller
passes ``device="cpu"``.  The phase-A scoring kernels are hand-written
CUDA (``csrc/phase_a.cu``, ``csrc/phase_a_fold.cu``,
``csrc/phase_a_i8.cu``, ``csrc/phase_a_i8_fold.cu``), built at first use
into ``build/kernels/``.  ``lambda_rt.serving.ServingLayer`` serves a
model replayed off the update topic, from a config such as
``conf/als-example.conf`` (of this package).
"""

__version__ = "0.1.0"
