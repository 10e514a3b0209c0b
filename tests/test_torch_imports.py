"""The port stands alone: elasticdl_tpu_torch and chip_smoke.py import
neither JAX nor anything of the JAX package, nor grpc or protobuf
(`google`: the control plane's wire format is written by hand), so they
run on a machine that has none of them.

One check imports every port module and chip_smoke.py in a fresh
interpreter and inspects the modules those imports loaded (not the ones
the interpreter's site hooks loaded before: a namespace-package .pth
file may pre-load an empty `google` package); the other scans the
sources for import statements naming the forbidden packages.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import elasticdl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(elasticdl_tpu_torch.__file__)
FORBIDDEN_TOPS = ("jax", "jaxlib", "flax", "optax", "orbax", "grpc",
                  "google", "ml_dtypes", "elasticdl_tpu", "model_zoo")


def _forbidden(name):
    """True for `jax`, `jax.numpy`, `elasticdl_tpu.x` ...; False for the
    port's own `elasticdl_tpu_torch` and anything else."""
    return name.split(".")[0] in FORBIDDEN_TOPS


def _port_modules():
    names = [elasticdl_tpu_torch.__name__]
    for info in pkgutil.walk_packages([PKG_DIR],
                                      prefix="elasticdl_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG_DIR):
        paths.extend(os.path.join(root, f) for f in files
                     if f.endswith(".py"))
    return sorted(paths)


def test_port_modules_import_no_jax_package():
    modules = _port_modules()
    for required in ("elasticdl_tpu_torch.serving.engine",
                     "elasticdl_tpu_torch.training.trainer",
                     "elasticdl_tpu_torch.api.local_executor",
                     "elasticdl_tpu_torch.embedding.layer",
                     "elasticdl_tpu_torch.embedding.sparse_update",
                     "elasticdl_tpu_torch.model_zoo.dlrm",
                     "elasticdl_tpu_torch.parallel.context_parallel",
                     "elasticdl_tpu_torch.parallel.mesh",
                     "elasticdl_tpu_torch.checkpoint",
                     "elasticdl_tpu_torch.checkpoint.saver",
                     "elasticdl_tpu_torch.master.state_store",
                     "elasticdl_tpu_torch.master.task_dispatcher",
                     "elasticdl_tpu_torch.common.fault_injection",
                     "elasticdl_tpu_torch.common.dtypes",
                     "elasticdl_tpu_torch.common.tensor_utils",
                     "elasticdl_tpu_torch.common.prng",
                     "elasticdl_tpu_torch.worker.prediction_outputs_processor",
                     "elasticdl_tpu_torch.serving.hot_reload",
                     "elasticdl_tpu_torch.observability.histogram",
                     "elasticdl_tpu_torch.proto.messages",
                     "elasticdl_tpu_torch.proto.convert",
                     "elasticdl_tpu_torch.proto.service",
                     "elasticdl_tpu_torch.common.retry",
                     "elasticdl_tpu_torch.common.args",
                     "elasticdl_tpu_torch.common.timing_utils",
                     "elasticdl_tpu_torch.common.job_status",
                     "elasticdl_tpu_torch.data.reader.data_reader_factory",
                     "elasticdl_tpu_torch.master.servicer",
                     "elasticdl_tpu_torch.master.evaluation_service",
                     "elasticdl_tpu_torch.master.master",
                     "elasticdl_tpu_torch.master.instance_manager",
                     "elasticdl_tpu_torch.master.main",
                     "elasticdl_tpu_torch.worker.task_data_service",
                     "elasticdl_tpu_torch.worker.worker",
                     "elasticdl_tpu_torch.worker.main",
                     "elasticdl_tpu_torch.client.api",
                     "elasticdl_tpu_torch.client.main"):
        assert required in modules, required
    script = (
        "import importlib.util, json, sys\n"
        "before = set(sys.modules)\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', %r)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
        % (modules, os.path.join(REPO, "chip_smoke.py"))
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "elasticdl_tpu_torch.ops.attention" in loaded
    assert "elasticdl_tpu_torch.ops.embedding_ops" in loaded
    assert "elasticdl_tpu_torch.checkpoint.saver" in loaded
    assert "torch" in loaded
    leaked = [m for m in loaded if _forbidden(m)]
    assert not leaked, leaked


def test_port_sources_name_no_jax_package():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if not node.level else []
            else:
                continue
            offenders.extend("%s: %s" % (os.path.relpath(path, REPO), n)
                             for n in names if _forbidden(n))
    assert not offenders, offenders
    assert not _forbidden("elasticdl_tpu_torch.ops")
    assert _forbidden("elasticdl_tpu.ops") and _forbidden("jax")
