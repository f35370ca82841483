"""The PyTorch port stands alone: no module of ``src/repro_torch`` and no
line of ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_files_exist():
    csrc = sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES + csrc}
    for want in (
        "src/repro_torch/core/prng.py", "src/repro_torch/core/mc.py",
        "src/repro_torch/core/selection.py", "src/repro_torch/serving/router.py",
        "src/repro_torch/kernels/ops.py", "src/repro_torch/convert.py", "chip_smoke.py",
        "src/repro_torch/models/model.py", "src/repro_torch/models/blocks.py",
        "src/repro_torch/configs/__init__.py", "src/repro_torch/kernels/flash_attention.py",
        "src/repro_torch/kernels/rglru_scan.py", "src/repro_torch/kernels/mamba_scan.py",
        "src/repro_torch/kernels/causal_conv1d.py", "src/repro_torch/csrc/causal_conv1d.cu",
        "src/repro_torch/kernels/mc_correctness.py", "src/repro_torch/csrc/mc_correctness.cu",
        "src/repro_torch/core/cascade.py", "src/repro_torch/core/belief.py",
        "src/repro_torch/budget_sweep.py", "src/repro_torch/distributed/fault.py",
        "src/repro_torch/serving/feedback.py", "src/repro_torch/serving/scheduler.py",
        "src/repro_torch/serving/replica.py", "src/repro_torch/distributed/sharding.py",
        "src/repro_torch/launch/__init__.py", "src/repro_torch/launch/serve.py",
        "src/repro_torch/quickstart.py", "src/repro_torch/training/optimizer.py",
        "src/repro_torch/training/compression.py", "src/repro_torch/training/train_loop.py",
        "src/repro_torch/training/__init__.py", "src/repro_torch/checkpoint/ckpt.py",
        "src/repro_torch/checkpoint/__init__.py", "src/repro_torch/data/pipeline.py",
        "src/repro_torch/data/tokenizer.py", "src/repro_torch/launch/train.py",
        "src/repro_torch/train_and_serve.py", "src/repro_torch/models/moe.py",
        "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/specs.py",
        "src/repro_torch/launch/roofline.py", "src/repro_torch/launch/dryrun.py",
        "src/repro_torch/analysis/__init__.py", "src/repro_torch/analysis/walker.py",
        "src/repro_torch/analysis/__main__.py",
    ):
        assert want in names
    for module in ("h2o_danube_1_8b", "qwen1_5_110b", "starcoder2_7b", "granite_moe_1b_a400m",
                   "moonshot_v1_16b_a3b", "internvl2_2b", "musicgen_medium"):
        assert f"src/repro_torch/configs/{module}.py" in names


def test_training_exports_the_reference_names():
    """The training slice keeps the JAX package's public names (written out
    here: this file imports neither package's JAX side)."""
    import repro_torch.checkpoint as checkpoint
    import repro_torch.data as data
    import repro_torch.distributed as distributed
    import repro_torch.training as training

    assert set(training.__all__) == {
        "OptimizerConfig", "adamw_init", "adamw_update", "global_norm", "lr_at",
        "CompressionConfig", "compress_grads", "init_residuals",
        "init_train_state", "make_train_step",
    }
    assert checkpoint.__all__ == ["CheckpointManager"]
    assert set(data.__all__) == {"OracleWorkload", "make_token_task", "DataPipeline",
                                 "host_shard_fn", "encode", "decode", "encode_batch", "VOCAB_SIZE"}
    for name in ("HeartbeatMonitor", "plan_elastic_remesh", "rebatch_for_mesh",
                 "FaultTolerantDriver", "StragglerMitigator"):
        assert name in distributed.__all__
    for mod in (training, checkpoint, data, distributed):
        assert all(hasattr(mod, name) for name in mod.__all__)


def test_serving_exports_the_front_door():
    """``repro_torch.serving`` exports what the reference's serving package
    does, but the compile cache; ``repro_torch.distributed`` exports
    ``replica_devices``."""
    import repro_torch.distributed as distributed
    import repro_torch.serving as serving

    assert "replica_devices" in distributed.__all__ and hasattr(distributed, "replica_devices")
    for name in ("ReplicaSet", "ReplicaWorker",
                 "BatchScheduler", "CostLedger", "Request", "RequestFuture", "RequestResult",
                 "BlockFuture", "FeedbackLog", "FeedbackReport", "FeedbackShard",
                 "DegradationTracker", "merge_counts", "ArmFaultSpec", "FaultPolicy",
                 "USD_PER_FLOP", "LMArm", "OracleArm", "PoolEngine", "GroupPlan", "PlanService",
                 "ThriftRouter", "RouteResult", "PendingRoute"):
        assert name in serving.__all__ and hasattr(serving, name), name


def test_core_exports_the_reference_names():
    """``repro_torch.core.__all__`` is ``repro.core.__all__`` (written out
    here: this file imports neither package's JAX side)."""
    import repro_torch.core as core

    want = {
        "Arm", "QueryClass", "SelectionResult", "InvocationResult", "clip_probs",
        "log_weight", "empty_log_belief", "aggregate_log_beliefs", "aggregate_predict",
        "aggregate_log_beliefs_batch", "predict_batch", "predict_from_beliefs",
        "tie_break_argmax", "top2_beliefs",
        "gamma", "gamma_marginal", "xi_exact", "xi_exact_feasible", "xi_pair",
        "McXiEstimator", "GroupedXiEstimator", "sample_pool_responses",
        "sample_pool_responses_grouped", "theta_for",
        "xi_from_responses", "xi_from_responses_grouped", "xi_marginal_grouped",
        "greedy", "gamma_value_batch", "sur_greedy", "sur_greedy_many",
        "adaptive_invoke", "ThriftLLM",
        "SuccessProbEstimator", "ClusterStats", "hoeffding_interval", "wilson_interval",
        "median_boosted_interval", "median_boost_rounds",
        "kmeans", "dbscan", "auto_eps",
        "FrugalCascade", "blender_all", "topk_weighted", "single_best", "random_subset",
    }
    assert set(core.__all__) == want
    assert all(hasattr(core, name) for name in want)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import mc\nimport repro_torch\n")
    assert [m for _, m in _imported_roots(probe) if m in FORBIDDEN] == ["jax", "repro"]
