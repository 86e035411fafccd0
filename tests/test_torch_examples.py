"""The port's ``examples_torch/train_on_ply_dataset.py`` against the JAX
package's ``examples/train_on_ply_dataset.py``, both run through their
``main()`` on the CPU at a tiny size, and every port example's imports
(``test_torch_examples_short.py`` holds the other five examples).

The two directories hold modules of the same names, so each script is
loaded from its file under a name of its own (``examples_parity.load``).
The JAX example's model constructor is patched to record the model it
builds (built under ``nnx.jit``, as eager JAX compiles every op alone);
its initial parameters go to the port example through a patched
constructor that loads them with ``load_jax_params``. The examples
themselves take no extra argument.

The JAX example runs as written except where the test harness's 8 virtual
CPU devices would change it: ``jax.devices`` / ``jax.device_count`` are
patched to one device (the port drives one: no batch rounding), and its
Trainer gets a one-device mesh. It takes its "auto" routes (XLA on the
CPU); the run has no EMD term, so the reference's CPU fallback of the EMD
(a different algorithm) never enters. Both scripts' ``round`` is the
identity here, so their JSON artifacts hold the values themselves.

The run trains on 12 uniform clouds of 385-512 points (``--data``; one
bucket, so the JAX step compiles once) for three steps; ``make_dataset``
itself is held byte-equal apart. Past the first update the two runs'
parameters part at rounding level and Adam at lr 2e-3 amplifies the gap
about tenfold a step (on these clouds the second loss differs by 1.1e-5,
the third by 2.0e-4, a held-out f-score after one update by 5.6e-4: one
hit moved across the threshold), as the port's LayerNorm rounds apart from
flax's (two-pass variance, ~6e-7 of the first loss). So the
script-against-script bars stop at the second loss, and every loss and
metric the port script computed is held against the JAX package's value
on the same parameters and the same batch. On the example's own clouds
the runs part at the first update: its grid clouds are deformed one
coordinate at a time, many of SA1's centred offsets are collinear
((dx, 0, 0)), LayerNorm maps such rows to nearly one feature, and SA1's
max-pool is tied to an ulp in about 4% of its pooled entries, where each
package's rounding picks another row (SA1's first bias grad 15% of its
scale apart, the second loss 2%).

Tolerances: the first loss rtol 1e-5 and the second rtol 1e-4 against the
JAX script's; each loss rtol 1e-5 and each chamfer-L1 and f-score atol
1e-4 against the JAX package's on the same parameters.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import pytorch_points_tpu as jppt
import pytorch_points_tpu.models as jax_models
from examples_parity import (
    NAMES,
    ROOT,
    Carried,
    load,
    one_device,
    run_main,
    same_params,
)
from pytorch_points_tpu.losses import metrics as jax_metrics
from pytorch_points_tpu.utils.trainer import Trainer as JaxTrainer
from torch_inputs import write_ply_clouds

PLY_ARGS = ["--count", "12", "--batch", "2", "--steps", "3"]


# ---------------------------------------------------------------------------
# train_on_ply_dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ply_runs(tmp_path_factory):
    """Both scripts on one folder of uniform clouds: (jax, port) of
    (main's return, artifact); for the port also each training step's and
    each metric's batch, with the parameters of that moment and the
    values the script got."""
    tmp = tmp_path_factory.mktemp("ply_example")
    jex, pex = load("examples", NAMES[0]), load("examples_torch", NAMES[0])
    data = write_ply_clouds(tmp / "ply", count=12, lo=385, hi=512)
    carried, out = Carried(), {"steps": [], "evals": []}
    with pytest.MonkeyPatch.context() as mp:
        one_device(mp)
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))

        def trainer(*args, **kwargs):
            tr = JaxTrainer(*args, mesh=mesh, **kwargs)
            # replicated on the mesh from the start, as every step returns
            # it: one compile of the step instead of two
            tr.state = jax.device_put(tr.state, NamedSharding(mesh, P()))
            return tr

        mp.setattr(jex, "Trainer", trainer)
        mp.setattr(jax_models, "PointCloudAutoencoder",
                   carried.jax_ctor(jax_models.PointCloudAutoencoder))
        mp.setattr(jex, "round", lambda x, n=None: x, raising=False)
        ret = run_main(mp, jex, [*PLY_ARGS, "--data", data,
                                 "--json-out", str(tmp / "jax.json")])
        out["jax"] = ret, json.loads((tmp / "jax.json").read_text())
    out["jax_model"] = carried.model
    with pytest.MonkeyPatch.context() as mp:
        port_ctor = carried.port_ctor(pex.PointCloudAutoencoder)
        models = []
        mp.setattr(pex, "PointCloudAutoencoder",
                   lambda *a, **k: models.append(port_ctor(*a, **k))
                   or models[-1])

        def params():
            return {k: v.clone() for k, v in models[0].state_dict().items()}

        class Trainer(pex.Trainer):
            """The port's Trainer, recording each step's batch, the
            parameters it starts from and its loss."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                step_fn = self.step_fn

                def step(batch):
                    seen = {"params": params(), "points": batch["points"],
                            "mask": batch["mask"]}
                    seen["value"] = step_fn(batch).item()
                    out["steps"].append(seen)
                    return torch.tensor(seen["value"])

                self.step_fn = step

        def cl1_seen(pred, pts, p_mask=None, q_mask=None):
            value = pex_cl1(pred, pts, p_mask=p_mask, q_mask=q_mask)
            out["evals"].append({"params": params(), "points": pts,
                                 "mask": p_mask, "cl1": value.mean().item()})
            return value

        def fscore_seen(*args, **kwargs):
            value = pex_fscore(*args, **kwargs)
            out["evals"][-1]["fscore"] = value[0].mean().item()
            return value

        pex_cl1, pex_fscore = pex.chamfer_l1, pex.fscore
        mp.setattr(pex, "Trainer", Trainer)
        mp.setattr(pex, "chamfer_l1", cl1_seen)
        mp.setattr(pex, "fscore", fscore_seen)
        mp.setattr(pex, "round", lambda x, n=None: x, raising=False)
        ret = run_main(mp, pex, [*PLY_ARGS, "--data", data,
                                 "--json-out", str(tmp / "port.json"),
                                 "--device", "cpu"])
        out["port"] = ret, json.loads((tmp / "port.json").read_text())
    return out


def test_ply_example_writes_the_same_files(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    load("examples", NAMES[0]).make_dataset(str(jax_dir), count=12)
    load("examples_torch", NAMES[0]).make_dataset(str(port_dir), count=12)
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir)) and len(names) == 12
    for name in names:
        assert (jax_dir / name).read_bytes() == (port_dir / name).read_bytes()


def test_ply_example_losses_match(ply_runs):
    """The first two losses against the JAX script's; every loss the port
    script's Trainer got against the JAX package's loss of the same
    parameters on the same batch."""
    (jfirst, _, _, _), jart = ply_runs["jax"]
    (pfirst, pfinal, _, _), part = ply_runs["port"]
    jcurve, pcurve = jart["loss_curve"], part["loss_curve"]
    assert [e["step"] for e in pcurve] == [e["step"] for e in jcurve] == [
        1, 2, 3]
    np.testing.assert_allclose(pfirst, jfirst, rtol=1e-5)
    np.testing.assert_allclose(pcurve[1]["loss"], jcurve[1]["loss"],
                               rtol=1e-4)
    assert part["backend"] == "cpu" and part["device"] == "cpu"
    for key in ("steps", "batch", "train_clouds", "val_clouds", "bf16",
                "remat", "emd_weight"):
        assert part[key] == jart[key], key

    steps = ply_runs["steps"]
    assert [s["value"] for s in steps] == [e["loss"] for e in pcurve]
    assert pfinal == steps[-1]["value"] < pfirst
    loss = nnx.jit(lambda m, pts, mask: jppt.chamfer_distance(
        m(pts, mask=mask), pts, p_mask=mask, q_mask=mask))
    for seen in steps:
        want = loss(same_params(ply_runs["jax_model"], seen["params"]),
                    jnp.asarray(seen["points"].numpy()),
                    jnp.asarray(seen["mask"].numpy()))
        np.testing.assert_allclose(seen["value"], float(want), rtol=1e-5)


def test_ply_example_metrics_match(ply_runs):
    """Every metric the port script computed (held-out at steps 2 and 3,
    train and held-out at the end) against the JAX package's metrics of
    the same parameters on the same batch, and the script's numbers
    against the means of those values."""
    (_, _, pcl1, pfs), part = ply_runs["port"]
    evals = ply_runs["evals"]
    metrics = nnx.jit(lambda m, pts, mask: (
        jax_metrics.chamfer_l1(m(pts, mask=mask), pts, p_mask=mask,
                               q_mask=mask).mean(),
        jax_metrics.fscore(m(pts, mask=mask), pts, threshold=0.05,
                           pred_mask=mask, gt_mask=mask)[0].mean()))
    for e in evals:
        want = metrics(same_params(ply_runs["jax_model"], e["params"]),
                       jnp.asarray(e["points"].numpy()),
                       jnp.asarray(e["mask"].numpy()))
        np.testing.assert_allclose([e["cl1"], e["fscore"]],
                                   [float(v) for v in want], atol=1e-4)

    def means(seen):
        return [np.mean([e["cl1"] for e in seen]),
                np.mean([e["fscore"] for e in seen])]

    n_val = -(-part["val_clouds"] // part["batch"])
    n_train = len(evals) - 3 * n_val  # steps 2 and 3, and the end
    assert n_train >= 1
    keys = ("val_chamfer_l1", "val_fscore_at_0.05")
    val = [evals[:n_val], evals[n_val:2 * n_val], evals[-n_val:]]
    for entry, seen in zip(part["loss_curve"][1:], val):
        assert [entry[k] for k in keys] == means(seen)
    train = evals[2 * n_val:2 * n_val + n_train]
    assert [pcl1, pfs] == means(train)
    assert [part["train_chamfer_l1"], part["train_fscore_at_0.05"]] == \
        means(train)
    assert [part[k] for k in keys] == means(val[2])


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_examples_import_no_jax():
    """Every port example loads with jax, flax, optax and the JAX package
    blocked."""
    code = "\n".join([
        "import importlib.util, sys",
        "for m in ('jax', 'flax', 'optax', 'pytorch_points_tpu'):",
        "    sys.modules[m] = None",
        f"root = {str(ROOT)!r}",
        "sys.path.insert(0, root)",
        f"for name in {NAMES!r}:",
        "    spec = importlib.util.spec_from_file_location(",
        "        'examples_torch_' + name, f'{root}/examples_torch/{name}.py')",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py")) \
        == sorted(NAMES)
