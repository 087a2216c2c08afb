"""The benchmark of ``nf4_tpu_torch``: one cell (a model configuration under
a traffic mix) served through ``Engine.generate`` on one card, driven by the
data files under ``configs/``, ``traffic/``, ``metrics/`` and ``limits/``.

Run one cell once: ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.  Nothing here imports ``jax``, ``flax`` or
``nf4_tpu``; ``reference.py``, ``weights.py``, ``traffic.py``, ``work.py``
and ``model.py`` import nothing of ``nf4_tpu_torch`` either.
"""
