"""Declared candidate space per algorithm, the dimensions the search walks
in search order: the port of ``surreal_tpu/tune/space.py``, holding only
the knobs that change the port's program.

Every dimension is a learner-config ``algo.*`` key:

- ``precision``: the precision policy (ops/precision.py), 'f32' |
  'mixed' | 'bf16'. Searched FIRST: it is the biggest lever, and every
  later choice is measured under the adopted policy. The experimental
  'bf16_fp8' is deliberately NOT in the space, as in the reference:
  numerics experiments stay behind an explicit knob, never a timing
  search.
- ``gae_impl``: PPO's advantage recurrence, 'xla' (the GAE kernel,
  csrc/gae.cu) | 'assoc' (the reverse linear scan, csrc/rev_scan.cu).
- ``shuffle``: PPO's minibatch layout, 'block' (contiguous-block
  permute, the default) | 'row' (exact reference semantics).
- ``vtrace_impl``: IMPALA's V-trace recurrence, 'xla' (the V-trace
  kernel, csrc/vtrace.cu) | 'assoc' (the reverse linear scan).

Left out of the reference's space, because no value of them changes what
the port runs: the four unroll knobs (``rollout_unroll``, ``gae_unroll``,
``sgd_unroll``, ``update_unroll``), which unroll a ``lax.scan`` in the
JAX package while eager PyTorch runs the same loop step by step
(learners/base.py::check_scan_unroll); ``gae_impl``/``vtrace_impl``
'pallas', which launches the same CUDA kernel as 'xla' on the card; and
DDPG's ``replay_gather``, whose 'xla' and 'pallas' both launch
csrc/replay_rows.cu. Measuring them would time one program twice and
could adopt noise. So DDPG searches ``precision`` alone.

New knobs join the search by adding a dimension here plus the key to
fingerprint.TUNABLE_KEYS.
"""

from __future__ import annotations


def candidate_space(extended_learner_config) -> list[tuple[str, list]]:
    """[(dim_name, candidate_values)] in search order for this algo."""
    name = extended_learner_config.algo.name
    dims: list[tuple[str, list]] = [
        # precision first: later dims re-measure under the adopted policy
        ("precision", ["f32", "mixed", "bf16"]),
    ]
    if name == "ppo":
        dims.append(("gae_impl", ["xla", "assoc"]))
        dims.append(("shuffle", ["block", "row"]))
    elif name == "impala":
        dims.append(("vtrace_impl", ["xla", "assoc"]))
    return [(n, vals) for n, vals in dims if len(vals) > 1]


def default_point(extended_learner_config) -> dict:
    """The static-default value of every searched dimension: the incumbent
    the search must beat, and the 'untuned arm' artifacts record."""
    algo = extended_learner_config.algo
    return {
        name: algo.get(name)
        for name, _vals in candidate_space(extended_learner_config)
    }


def skip_dimension(name: str, incumbent: dict, extended_learner_config) -> bool:
    """Prune dimensions made moot by the incumbent, the reference's rule:
    ``gae_unroll`` (given through ``dims``) belongs to the 'xla'
    recurrence of PPO's ``gae_impl`` and IMPALA's ``vtrace_impl``."""
    algo_name = extended_learner_config.algo.name
    if name != "gae_unroll":
        return False
    if algo_name == "ppo":
        return incumbent.get("gae_impl", "xla") != "xla"
    if algo_name == "impala":
        return incumbent.get("vtrace_impl", "xla") != "xla"
    return False
