"""The port's spatial parallelism (`coma_unet_tpu_torch/parallel/spatial.py`)
against the JAX package's `make_spatial_infer_fn`, on the CPU at f32.

One subprocess (`tests/torch_port_sp_worker.py`, killed at 120 s) forks
N = 2 and then N = 4 gloo ranks, each holding a depth slab of one volume,
that run the port's `make_spatial_infer_fn`, and again with two planted
faults: every halo read as zeros, and each rank's own norm statistics left
unmerged. Meanwhile JAX compiles its `make_spatial_infer_fn` on a
`make_mesh(data=1, spatial=N)` mesh of the forced CPU devices, one program
per N, at XLA's backend optimization level 0.

Settings are the e2e parity test's (`tests/test_e2e_torch_parity.py`:
16^3, channels (4, 8, 16), 4 experts, f32, `pallas_convs=False`), at b=1
as the spatial path runs; at N = 4 the bottom level's slabs are one plane.
The weights are the port's seeded init with seeded noise and the flax
tree they map to (`test_torch_port_parallel._flagship_params`).

Tolerances: against JAX rtol 1e-4 and atol 1e-4 (the e2e forward's); against
the port's unsharded forward 1e-5 of max|out| (the sharded statistics are
merged in f64, the unsharded ones taken in f32); K4's two slab halves'
plain versions, merged over slabs, against the plain K4 on whole rows
1e-6; each planted fault must read above the 1e-4 limit.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jax_make_mesh,
    make_spatial_infer_fn as jax_spatial_infer_fn,
)
from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig, ops  # noqa: E402
from coma_unet_tpu_torch.ops.norm_act import mean_rstd  # noqa: E402
from coma_unet_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from coma_unet_tpu_torch.parallel.spatial import (  # noqa: E402
    Slab,
    make_spatial_infer_fn,
    plan_slabs,
)
from jax_fast import fast  # noqa: E402
from test_torch_port_baselines import ARGS, JAX_ONLY, TINY  # noqa: E402
from test_torch_port_parallel import _batch, _flagship_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_port_sp_worker.py"
SPAWN_TIMEOUT_S = 120
WORLDS = (2, 4)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
PORT_TOL = 1e-5       # of max|out|
MERGE_TOL = 1e-6
FAULTS = ("zero_halo", "unmerged")


def _excess(got, want, rtol, atol) -> float:
    """max |got - want| in units of the allowance atol + rtol |want|: <= 1
    passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    batch = {k: v[:1] for k, v in _batch(np.random.default_rng(1)).items()}
    state, params = _flagship_params(rng, batch)
    port = ContraAttnUNet(ModelConfig(**TINY), device="cpu")
    port.load_state_dict(state)
    args = tuple(batch[k] for k in ARGS)
    torch.save(dict(model=TINY, state=state, args=args, worlds=WORLDS),
               str(out / "inputs.pt"))

    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                       if p]))
    proc = subprocess.Popen(
        [sys.executable, str(WORKER), str(out / "inputs.pt"), str(out)],
        cwd=str(out), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        flax_model = FlaxContra(JaxModelConfig(**TINY, **JAX_ONLY))
        jargs = [{"params": params}] + [jnp.asarray(a) for a in args]
        want = {}
        for n in WORLDS:
            infer = fast(jax_spatial_infer_fn(flax_model, jax_make_mesh(data=1, spatial=n)))
            want[n] = np.asarray(jax.device_get(infer(*jargs)))
        with torch.no_grad():
            single = port(*(torch.from_numpy(a) for a in args),
                          with_projections=False).out.numpy()
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, SPAWN_TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log, _ = proc.communicate()
            pytest.fail(f"the ranks did not finish in {SPAWN_TIMEOUT_S} s:\n"
                        f"{log[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, log[-5000:]
    ranks = {n: [torch.load(str(out / f"n{n}_rank{r}.pt"), weights_only=False)
                 for r in range(n)] for n in WORLDS}
    return dict(want=want, single=single, ranks=ranks, port=port, args=args)


@pytest.mark.parametrize("n", WORLDS)
def test_spatial_forward_matches_jax(run, n):
    """N gloo ranks, each on its depth slab, against JAX's GSPMD forward on
    a data=1 x spatial=N mesh (rank 0 assembles `out`; the others return
    None)."""
    ranks = run["ranks"][n]
    got = ranks[0]["sound"]["out"]
    assert all(r["sound"]["out"] is None for r in ranks[1:])
    assert tuple(got.shape) == (1, 1, 16, 16, 16)
    assert _excess(got.numpy(), run["want"][n], **JAX_TOL) <= 1.0


@pytest.mark.parametrize("n", WORLDS)
def test_spatial_forward_matches_the_unsharded_port(run, n):
    got = run["ranks"][n][0]["sound"]["out"].numpy()
    single = run["single"]
    err = float(np.abs(got - single).max())
    assert err <= PORT_TOL * float(np.abs(single).max()), err


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_are_caught(run, fault, n):
    """Halos read as zeros, or each rank's own statistics unmerged: the
    result must miss JAX's by more than the 1e-4 limit."""
    got = run["ranks"][n][0][fault]["out"].numpy()
    assert _excess(got, run["want"][n], **JAX_TOL) > 1.0


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_runs_the_slab_halves_not_k4(run, n):
    """On each rank the sharded forward ran the plain versions of K1, K2,
    K3 and K4's two slab halves, and never the whole-row K4."""
    for rank in run["ranks"][n]:
        plain = rank["sound"]["plain"]
        assert all(plain.get(f, 0) > 0 for f in ("s1", "s2", "t2") + ops.SLAB_FAMILIES), plain
        assert plain.get("norm_act", 0) == 0, plain


@pytest.mark.parametrize("n", WORLDS)
def test_statistics_bit_identical_on_every_rank(run, n):
    """Every norm's merged (mean, rstd), in call order, is the same bits on
    every rank: each merges the same gathered buffer in rank order."""
    seen = [r["sound"]["stats"] for r in run["ranks"][n]]
    assert len(seen[0]) > 0
    for other in seen[1:]:
        assert len(other) == len(seen[0])
        assert all(torch.equal(a, b) for a, b in zip(other, seen[0]))


@pytest.mark.parametrize("act,film", [("none", False), ("relu", True),
                                      ("leakyrelu", True), ("prelu", True)])
def test_slab_halves_merge_to_k4(act, film):
    """`norm_stats_plain` on each of 4 depth slabs, `merge_partials` in slab
    order and `norm_apply_plain` with the merged statistics give the plain
    K4 on the whole rows within 1e-6."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((2.0 + rng.normal(size=(2, 3, 8, 5, 6))).astype(np.float32))
    alpha = torch.tensor([0.25])
    scale = shift = None
    if film:
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32))
        shift = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    parts = torch.stack([ops.norm_stats(s) for s in x.split(2, dim=2)])
    stats = mean_rstd(ops.merge_partials(parts))
    got = ops.norm_apply(x, stats, alpha, act, scale, shift)
    want = ops.norm_act_plain(x, alpha, act, scale, shift)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MERGE_TOL)


def test_an_uneven_plan_is_refused_before_any_rank_starts(run):
    """At 16^3 with 3 levels (16, 8, 4 planes), 8 ranks do not split level
    2: the plan and the infer function refuse it with ValueError before any
    collective (here there is no process group at all); a halo wider than
    the slab is refused too."""
    with pytest.raises(ValueError, match="level 2 holds 4 planes"):
        plan_slabs(16, (2, 2), 8)
    assert plan_slabs(16, (2, 2), 4).planes(3, 2) == slice(3, 4)
    infer = make_spatial_infer_fn(run["port"], Mesh(0, 8, torch.device("cpu")))
    with pytest.raises(ValueError, match="level 2 holds 4 planes"):
        infer(*run["args"])
    with pytest.raises(ValueError, match="wider than a slab"):
        Slab(Mesh(0, 2, torch.device("cpu"))).halo(torch.zeros(1, 1, 1, 2, 2), 2, 0)
