"""Port parity for the roofline analysis (``roofline/analysis.py``) and
the meta-device dry-run (``launch/dryrun.py``) against the JAX package,
on the CPU.

- ``n_params_active``, ``model_flops`` and ``roofline_terms`` are the JAX
  functions' arithmetic: equal bit for bit, for every config and shape;
- a mini dry-run runs in this process at reduced widths on a (2, 2)
  meta-device mesh (nothing allocated) and its records carry the keys
  the full one writes;
- one full-size cell (qwen1.5-110b ``train_4k`` on the single-pod mesh)
  holds every leaf's shard shape as JAX's ``NamedSharding.shard_shape``
  gives it on an ``AbstractMesh``, and 2,058,289,152 float32 parameter
  bytes per member, the JAX tree's count.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models.model import LM as JLM
from repro.roofline import analysis as janalysis
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.reduce import reduced
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis

torch.set_num_threads(2)

META = torch.device("meta")


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_analytic_roofline_functions_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert analysis.n_params_active(cfg) == janalysis.n_params_active(jcfg)
    for name in SHAPES:
        assert analysis.model_flops(cfg, SHAPES[name]) == \
            janalysis.model_flops(jcfg, JSHAPES[name])
    rng = np.random.default_rng(len(arch))
    for _ in range(20):
        f, b, c = (float(x) for x in rng.uniform(0, 1e15, 3))
        if rng.random() < 0.2:
            c = 0.0
        assert analysis.roofline_terms(f, b, c) == \
            janalysis.roofline_terms(f, b, c)
        assert analysis.roofline_terms(f, b, c, analysis.H100) == \
            janalysis.roofline_terms(f, b, c, janalysis.HW(
                peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9))
    assert analysis.roofline_terms(0.0, 0.0, 0.0) == \
        janalysis.roofline_terms(0.0, 0.0, 0.0)
    assert analysis.HW() == analysis.HW(197e12, 819e9, 50e9)


KEYS = {"arch", "shape", "mesh", "mesh_shape", "n_devices", "shard_shapes",
        "memory", "per_device", "roofline"}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama4-scout-17b-a16e",
                                  "mamba2-130m"])
def test_mini_dryrun_on_a_2x2_meta_mesh(arch):
    cfg = reduced(get_config(arch))
    mesh = Mesh((META,) * 4, ("data", "model"), (2, 2))
    for name in ("train_4k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], seq_len=64, global_batch=8)
        rec = dryrun.run_cell(arch, name, False, cfg=cfg, shape=shape,
                              mesh=mesh)
        assert KEYS <= set(rec) and rec["n_devices"] == 4
        mem = rec["memory"]
        assert mem["argument_GiB"] > 0 and mem["total_GiB"] >= \
            mem["argument_GiB"] and mem["fits_80GiB"]
        assert ("grads_GiB" in mem) == (name == "train_4k")
        pd = rec["per_device"]
        assert pd["flops"] > 0 and pd["bytes"] > 0
        # every family serves and trains on the mesh (item 7g is done)
        assert pd["collective_bytes"] > 0 and "mesh_gap" not in rec
        assert ("flops_note" in rec) == bool(cfg.n_experts)
        r = rec["roofline"]
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["hw"]["peak_flops"] == 989e12
        assert r["model_flops_per_dev"] == r["model_flops_global"] / 4
        assert 0 < r["useful_flops_ratio"]
        for key, local in rec["shard_shapes"].items():
            assert all(n > 0 for n in local), key
        # nothing was allocated: the model's storage sits on the meta device
        lm = dryrun.make_lm(cfg, shape, mesh)
        assert lm.params["embed"].shards[0].device == META


def test_full_size_cell_shard_shapes_equal_jax():
    """qwen1.5-110b ``train_4k`` on the (16, 16) mesh, memory only."""
    rec = dryrun.run_cell("qwen1.5-110b", "train_4k", False, roofline=False)
    am = AbstractMesh((16, 16), ("data", "model"))
    jlm = JLM(jget_config("qwen1.5-110b"), tp=16, mesh=am)
    from repro.models.common import ParamDef

    def walk(defs, specs, prefix=()):
        if isinstance(defs, ParamDef):
            yield prefix, JNamedSharding(am, specs).shard_shape(defs.shape)
            return
        for k in sorted(defs):
            yield from walk(defs[k], specs[k], prefix + (k,))
    want = {"params/" + "/".join(p): list(s)
            for p, s in walk(jlm.param_defs(), jlm.param_specs())}
    got = {k: v for k, v in rec["shard_shapes"].items()
           if k.startswith("params/")}
    assert got == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert rec["memory"]["bytes"]["params"] == 4 * n == 2_058_289_152
    jin = jlm.input_shardings(JSHAPES["train_4k"])
    for name, sh in jin.items():
        spec = jlm.input_specs(JSHAPES["train_4k"])[name]
        assert rec["shard_shapes"]["inputs/" + name] == \
            list(sh.shard_shape(spec.shape))
    assert set(rec["per_device"]) == {"collective_bytes"}
    assert rec["per_device"]["collective_bytes"] > 0
    assert rec["n_devices"] == 256


def test_cli_writes_a_record_per_cell(tmp_path):
    out = tmp_path / "dryrun_torch.json"
    rc = dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                      "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert set(res) == {"tinyllama-1.1b|decode_32k|single",
                        "tinyllama-1.1b|decode_32k|multi"}
    assert "roofline" in res["tinyllama-1.1b|decode_32k|single"]
    assert "roofline" not in res["tinyllama-1.1b|decode_32k|multi"]
    assert res["tinyllama-1.1b|decode_32k|multi"]["n_devices"] == 512
    # both meshes' records carry the port mesh's collective bytes
    for key in res:
        assert res[key]["per_device"]["collective_bytes"] > 0
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0       # cached: skipped
    # JAX's cells(): every shape, long_500k only where supports_long
    want = [(a, s) for a in dryrun.ARCHS for s in JSHAPES
            if s != "long_500k" or jget_config(a).supports_long]
    assert list(dryrun.cells()) == want and len(want) == 34
