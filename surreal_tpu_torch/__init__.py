"""PyTorch/CUDA port of ``surreal_tpu`` for NVIDIA Hopper (H100).

The JAX package ``surreal_tpu`` beside it is the reference: every module
here mirrors its twin's path and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
numpy only, never JAX or any module of ``surreal_tpu``.

Entry points (``launch.trainer.Trainer``, ``learners.build_learner``,
``envs.make_env``) run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise rather than fall back.
"""
