"""The probe-serving quality bound on the trained field, on the port: the
counterpart of tests/test_probe_quality_trained.py (same fixture, config,
item, camera, raster and bounds), through
`scenedino_torch.tools.probe_quality_trained`.

The committed stage-1 field `tests/goldens/s1b_field_params.npz` is loaded
into the port through `utils.convert.from_jax_params` (strictly, by
`load_jax_params`); the item is the last of
configs/train_synthetic_convergence.yaml's synthetic dataset, built by the
port's loader (equal to JAX's, tests/test_torch_train_run.py). At the
96x192 serving raster: a gold render of 128 stratified samples (the fused
renderer, as the JAX test's: K2 on the card), the exact 32-sample render and the probe-guided render at its defaults of the
held-out novel camera; the JAX test's bounds (:104-110): the probe's
median and 95th-percentile depth error within 3.5x the exact path's
(+1e-6), its median below 0.25, its feature cosine to the gold median >
0.999 and 5th percentile > 0.99. The strata are the port's, from explicit
generators (seed 0). On the CPU the renders run the kernels' plain
versions on the fp32 state, as the JAX test's; the card's run (bf16 state,
K3, the row gather, K2) is tests/test_torch_kernels.py's and chip_smoke.py
phase 14f. This file imports no JAX.
"""
import torch

from scenedino_torch.tools import probe_quality_trained as pq


def test_probe_bound_on_the_trained_field():
    torch.set_num_threads(1)
    err_p, err_e, cos, counts = pq.probe_errors("cpu")
    assert not any(counts.values())  # the CPU runs the plain versions
    stats, failed = pq.bound(err_p, err_e, cos)
    assert not failed, (failed, stats)
    assert err_p.shape == err_e.shape == cos.shape == (pq.H, pq.W)
