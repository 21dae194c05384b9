"""The PyTorch port's driver entry points (``raytracer_tpu_torch/graft_entry.py``)
on the CPU against the JAX package's ``__graft_entry__.py``: ``entry()``'s
forward frame (rgb within atol 1e-5, ``tri`` by the tie rule of
``tests/torch_parity.py``), and ``dryrun_multichip(2)`` in two gloo ranks."""

import sys
from pathlib import Path

import numpy as np
import torch

from raytracer_tpu.render import render_ldr as jax_render_ldr
from raytracer_tpu_torch import graft_entry
from raytracer_tpu_torch.ops.camera import primary_dirs
from raytracer_tpu_torch.render import render_ldr
from torch_parity import FOV, assert_hits_parity

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as jax_graft  # noqa: E402


def test_entry_matches_the_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (64, 64, 3) and out.dtype == torch.float32 and out.device.type == "cpu"
    assert bool(torch.isfinite(out).all())
    jfn, jargs = jax_graft.entry()
    ref = np.asarray(jfn(*jargs))
    _, tris = graft_entry._small_scene("cpu")
    np.testing.assert_array_equal(tris.numpy(), np.asarray(jargs[1]))
    _, t, tri = render_ldr(*args, 64, 64)
    _, ref_t, ref_tri = jax_render_ldr(*jargs, 64, 64)
    py, px = torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")
    dirs = primary_dirs(px.reshape(-1), py.reshape(-1), 64, 64, graft_entry.CAM_QUAT, FOV)
    same = assert_hits_parity(t.numpy(), tri.numpy(), np.asarray(ref_t), np.asarray(ref_tri),
                              tris.numpy(), dirs, origins=graft_entry.CAM_POS)
    assert (tri.numpy() >= 0).any()
    np.testing.assert_allclose(out.numpy().reshape(-1, 3)[same], ref.reshape(-1, 3)[same],
                               atol=1e-5, rtol=0)


def test_dryrun_multichip_2_cpu():
    lines = graft_entry.dryrun_multichip(2, device="cpu")
    assert len(lines) == 2 and all(line.endswith("OK") for line in lines)
