"""The port's inference slice end to end against the JAX NeMAR model.

A JAX ``nemar`` model (ResNet-6 G at ngf 32, depth-3 UNet STN at stn_ngf 8,
32^2) gets a non-zero flow head and non-zero biases; its parameters are
converted with ``flax_to_torch`` and written as the port's per-net
checkpoints ``latest_net_{G,D,R}.pth``. The port then loads them through
its own options and ``setup()`` and runs on the CPU (``--gpu_ids -1``), and
its visuals and flow are held against JAX ``model.forward()`` on the same
synthetic batch, tolerance 1e-4. The test entry point
``nemar_tpu_torch.test`` runs on the same checkpoints and its registration
summary is held against the same metrics computed from the JAX outputs.
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

from nemar_tpu.data.synthetic_dataset import SyntheticDataset
from nemar_tpu.models import create_model as jax_create_model
from nemar_tpu.options import TrainOptions as JaxTrainOptions
from nemar_tpu.parallel import replicate
from nemar_tpu.utils import metrics as M
from nemar_tpu_torch import test as port_test
from nemar_tpu_torch.models import create_model
from nemar_tpu_torch.options import TestOptions
from nemar_tpu_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = ["--model", "nemar", "--dataset_mode", "synthetic", "--name", "slice",
         "--crop_size", "32", "--load_size", "32", "--ngf", "32", "--ndf", "8",
         "--stn_ngf", "8", "--stn_depth", "3", "--synthetic_size", "3"]
VISUALS = ["real_A", "real_B", "fake_B", "reg_fakeB", "warped_A", "fake_B2"]


def _port_args(root, *extra):
    return [*SLICE, "--gpu_ids", "-1", "--checkpoints_dir", str(root / "ckpt"),
            "--results_dir", str(root / "results"), *extra]


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """(root, batch, JAX visuals, JAX flow) with the port's checkpoints on disk."""
    root = tmp_path_factory.mktemp("slice")
    jopt = JaxTrainOptions().parse(["--dataroot", "__synthetic__", "--batch_size", "1",
                                    "--checkpoints_dir", str(root / "jax"), *SLICE])
    jmodel = jax_create_model(jopt)
    rng = np.random.default_rng(0)
    params = {}
    for name in "GDR":
        tree = jax.tree_util.tree_map(np.asarray, jax.device_get(
            getattr(jmodel.state, f"params_{name}")))

        def redraw(path, leaf):
            if path[-1].key == "bias":
                return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
            return leaf

        params[name] = jax.tree_util.tree_map_with_path(redraw, tree)
    head = params["R"]["params"][f"Conv_{len(params['R']['params']) - 1}"]
    head["kernel"] = (0.01 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    jmodel.state = replicate(jmodel.state.replace(
        **{f"params_{n}": jax.tree_util.tree_map(jnp.asarray, p) for n, p in params.items()}),
        jmodel.mesh)

    ds = SyntheticDataset(jopt)
    items = [ds[i] for i in range(3)]
    batch = {k: np.stack([it[k] for it in items]) for k in ("A", "B", "theta_gt")}
    jmodel.set_input(batch)
    jmodel.forward()
    jvis = {k: np.asarray(v) for k, v in jmodel.get_current_visuals().items()}
    jflow = np.asarray(jmodel.last_flow)

    popt = TestOptions().parse(_port_args(root))
    pmodel = create_model(popt)
    for name, tree in params.items():
        net = getattr(pmodel, f"net{name}")
        net.load_state_dict(flax_to_torch(tree, net))
    pmodel.save_networks("latest")
    return root, batch, jvis, jflow


@pytest.mark.parametrize("extra", [[], ["--g_batch"]], ids=["default", "g_batch"])
def test_port_slice_matches_jax_forward(slice_setup, extra):
    """Both forward orders of the reference (--g_batch: R first, one G pass
    at 2N) give the JAX default forward's outputs."""
    root, batch, jvis, jflow = slice_setup
    opt = TestOptions().parse(_port_args(root, *extra))
    model = create_model(opt)
    model.setup(opt)  # loads latest_net_{G,D,R}.pth
    model.set_input(batch)
    model.test()
    vis = model.get_current_visuals()
    assert list(vis) == list(jvis) == VISUALS
    # the field is a few pixels (1 px = 2/32 normalised) and fractional
    assert 0.5 < np.abs(jflow).max() * 16 < 8.0
    np.testing.assert_allclose(model.last_flow, jflow, atol=1e-4, rtol=0)
    for k in VISUALS:
        assert vis[k].shape == jvis[k].shape, k
        np.testing.assert_allclose(vis[k], jvis[k], atol=1e-4, rtol=0, err_msg=k)


def test_port_test_entry_point_matches_jax_metrics(slice_setup):
    root, batch, jvis, jflow = slice_setup
    summary = port_test.main(_port_args(root, "--eval_registration", "--num_test", "3"))
    web = root / "results" / "slice" / "test_latest"
    assert json.loads((web / "eval.json").read_text()) == summary
    assert (web / "index.html").exists()
    reg, real = jvis["reg_fakeB"], jvis["real_B"]
    want = {
        "ncc": np.mean([M.ncc(reg[j:j + 1], real[j:j + 1]) for j in range(3)]),
        "psnr": np.mean([M.psnr(reg[j:j + 1], real[j:j + 1]) for j in range(3)]),
        "l1": np.mean([M.l1(reg[j:j + 1], real[j:j + 1]) for j in range(3)]),
        "epe_px": np.mean([M.epe_px(jflow[j], M.registration_gt_flow(batch["theta_gt"][j], 32, 32),
                                    32, 32) for j in range(3)]),
    }
    assert set(summary) == set(want)
    for k, v in want.items():
        assert abs(summary[k] - v) < (1e-2 if k == "psnr" else 1e-3), (k, summary[k], v)


def test_port_refuses_missing_checkpoints(tmp_path):
    opt = TestOptions().parse(_port_args(tmp_path))
    model = create_model(opt)
    with pytest.raises(FileNotFoundError, match="refusing to run"):
        model.setup(opt)


def test_port_path_imports_no_jax(tmp_path):
    """Importing the entry point and running a forward pulls in no JAX and
    no module of the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "import nemar_tpu_torch.test\n"
        "from nemar_tpu_torch.models import create_model\n"
        "from nemar_tpu_torch.options import TestOptions\n"
        f"opt = TestOptions().parse({_port_args(tmp_path)!r})\n"
        "m = create_model(opt)\n"
        "m.set_input({'A': np.zeros((1, 32, 32, 1), np.float32),\n"
        "             'B': np.zeros((1, 32, 32, 3), np.float32)})\n"
        "m.test()\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'nemar_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_field_source_fake_predicts_from_the_translation(tmp_path):
    opt = TestOptions().parse(_port_args(tmp_path, "--stn_field_source", "fake"))
    model = create_model(opt)
    assert model.netR.Conv_0.in_channels == 6  # (fake_B, real_B)
    model.set_input({"A": np.zeros((2, 32, 32, 1), np.float32),
                     "B": np.ones((2, 32, 32, 3), np.float32)})
    model.test()
    assert model.last_flow.shape == (2, 32, 32, 2)
    assert model.get_current_visuals()["reg_fakeB"].shape == (2, 32, 32, 3)


@pytest.mark.parametrize("flag", [["--bf16"], ["--use_ema"], ["--init_type", "xavier"],
                                  ["--mesh_spatial", "2"], ["--stn_type", "affine"],
                                  ["--netG", "unet_256"]])
def test_unported_flags_raise(tmp_path, flag):
    """Flags of paths not ported yet raise, naming their ROADMAP.md item.
    ``--stn_type affine`` was one until the affine STN was ported,
    ``--init_type xavier`` and ``--use_ema`` until A5 was, and ``--bf16``
    until A7 was: each now builds and answers a request (``--bf16``'s
    outputs fp32, as the JAX package's); ``--use_ema`` first loads the EMA
    shadows, and without them on disk its setup raises (never random
    weights). ``--netG unet_256`` was one until A9 was: it now builds a UNet
    G, whose forward at this 32^2 crop raises the JAX package's error (it
    needs 256^2)."""
    opt = TestOptions().parse(_port_args(tmp_path, *flag))
    if flag in (["--stn_type", "affine"], ["--init_type", "xavier"], ["--use_ema"],
                ["--bf16"]):
        model = create_model(opt)
        if flag == ["--stn_type", "affine"]:
            assert type(model.netR).__name__ == "AffineSTN"
        if flag == ["--use_ema"]:
            model.save_networks("latest")
            with pytest.raises(FileNotFoundError, match="EMA shadow of net G"):
                model.setup(opt)
        model.set_input({"A": np.zeros((2, 32, 32, 1), np.float32),
                         "B": np.ones((2, 32, 32, 3), np.float32)})
        model.test()
        assert model.last_flow.shape == (2, 32, 32, 2)
        assert model.last_flow.dtype == np.float32
        return
    if flag == ["--netG", "unet_256"]:
        model = create_model(opt)
        assert type(model.netG).__name__ == "UnetGenerator"
        model.set_input({"A": np.zeros((1, 32, 32, 1), np.float32),
                         "B": np.ones((1, 32, 32, 3), np.float32)})
        with pytest.raises(ValueError, match="divisible by and >= 256"):
            model.test()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_model(opt)


@pytest.mark.parametrize("flag", [["--c7_impl", "roll"], ["--block_impl", "pallas_all"]])
def test_tpu_layout_flags_accepted(tmp_path, flag):
    """The TPU layouts of G's head and decoder run the port's one path: the
    same outputs as the default flags, from the same checkpoint."""
    base = create_model(TestOptions().parse(_port_args(tmp_path)))
    model = create_model(TestOptions().parse(_port_args(tmp_path, *flag)))
    model.netG.load_state_dict(base.netG.state_dict())
    model.netR.load_state_dict(base.netR.state_dict())
    batch = {"A": np.random.default_rng(5).standard_normal((1, 32, 32, 1)).astype(np.float32),
             "B": np.zeros((1, 32, 32, 3), np.float32)}
    outs = []
    for m in (base, model):
        m.set_input(batch)
        m.test()
        outs.append(m.get_current_visuals())
    for k in ("fake_B", "reg_fakeB", "fake_B2"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_gpu_ids_ask_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for CPU-only machines")
    opt = TestOptions().parse([*SLICE, "--gpu_ids", "0", "--checkpoints_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="gpu_ids"):
        create_model(opt)
