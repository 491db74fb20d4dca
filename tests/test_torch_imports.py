"""The PyTorch port stands alone: no JAX, no rtfs_tpu, and its own preset.

``rtfs_tpu_torch`` (every submodule) and ``chip_smoke.py`` must import
neither ``jax``/``flax``/``optax`` nor ``rtfs_tpu`` or any of its modules;
the check runs in a fresh interpreter and looks at what the imports add to
``sys.modules`` (exact names: ``rtfs_tpu_torch`` itself starts with
``rtfs_tpu``). The shipped JSON preset must equal the JAX package's YAML.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rtfs_tpu")

_PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    before = set(sys.modules)
    import rtfs_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        rtfs_tpu_torch.__path__, "rtfs_tpu_torch."))
    for n in names:
        importlib.import_module(n)
    import chip_smoke
    added = sorted(set(sys.modules) - before)
    print(json.dumps({"modules": names, "added": added}))
""")


def _probe():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_rtfs_tpu():
    res = _probe()
    for mod in ("rtfs_tpu_torch.ops.sru_fused", "rtfs_tpu_torch.ops.convt_tm",
                "rtfs_tpu_torch.models.avnet", "rtfs_tpu_torch.utils.weights",
                "rtfs_tpu_torch.models.video", "rtfs_tpu_torch.losses.sdr",
                "rtfs_tpu_torch.losses.pit", "rtfs_tpu_torch.train.optim",
                "rtfs_tpu_torch.train.system", "rtfs_tpu_torch.train.main",
                "rtfs_tpu_torch.train.checkpoints",
                "rtfs_tpu_torch.data.synthetic",
                "rtfs_tpu_torch.utils.parser",
                "rtfs_tpu_torch.ops.packed_tf", "rtfs_tpu_torch.inference",
                "rtfs_tpu_torch.data.transforms", "rtfs_tpu_torch.data.wav"):
        assert mod in res["modules"]
    bad = [m for m in res["added"] if m.split(".")[0] in FORBIDDEN]
    assert bad == [], bad


def test_no_import_statement_names_jax_or_rtfs_tpu():
    """No line of the port or chip_smoke.py imports a forbidden package,
    not even inside a function that the probe above does not run."""
    pattern = re.compile(
        r"^\s*(import|from) (jax|jaxlib|flax|optax|rtfs_tpu)\b(?!_torch)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rtfs_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as f:
            hits += [f"{path}:{i}" for i, line in enumerate(f, 1)
                     if pattern.match(line)]
    assert len(files) > 20 and hits == [], hits


@pytest.mark.parametrize("name", ["lrs2_RTFSNet_4_layer"])
def test_json_preset_equals_yaml(name):
    with open(os.path.join(REPO, "rtfs_tpu_torch", "configs",
                           f"{name}.json")) as f:
        port = json.load(f)
    with open(os.path.join(REPO, "rtfs_tpu", "configs", f"{name}.yaml")) as f:
        ref = yaml.safe_load(f)
    assert port == ref


def test_load_config_reads_json_preset_and_yaml_path():
    from rtfs_tpu_torch.config import list_presets, load_config

    assert "lrs2_RTFSNet_4_layer" in list_presets()
    yaml_path = os.path.join(REPO, "rtfs_tpu", "configs",
                             "lrs2_RTFSNet_4_layer.yaml")
    assert load_config("lrs2_RTFSNet_4_layer") == load_config(yaml_path)
    with pytest.raises(FileNotFoundError):
        load_config("no_such_preset")
