"""Example on the PyTorch port: elastic-cluster walkthrough — the paper's
guarantees driving every placement layer of the framework.

    PYTHONPATH=src python examples/elastic_cluster_torch.py              # the CUDA card
    PYTHONPATH=src python examples/elastic_cluster_torch.py --device cpu

The counterpart of ``examples/elastic_cluster.py``, line for line; the
checkpoint manager plans its resize over a temporary directory of its own.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import DataConfig, ShardedDataPipeline
from repro_torch.device import describe, resolve_device
from repro_torch.models import model as M
from repro_torch.placement.elastic import FailureDomain, plan_expert_migration
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import TrainHparams, make_train_state
from repro_torch.tree import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    device = resolve_device(ap.parse_args(argv).device)
    print(describe(device))

    print("=== 1. data fleet: 16 -> 20 hosts ===")
    pipe = ShardedDataPipeline(DataConfig(1000, 32, 32, num_shards=1024), 16, 0)
    plan = pipe.rescale(20)
    print(f"shards moved: {plan.moved_fraction:.4f} (ideal ~{4/20:.4f}); "
          f"all to new hosts: {plan.destinations() <= {16,17,18,19}}")

    print("=== 2. MoE expert-parallel group: 16 -> 24 devices ===")
    m = plan_expert_migration(256, 16, 24)
    print(f"experts moved: {len(m.plan.moves)}/256 "
          f"(ideal ~{256*8//24}); only to new devices: "
          f"{m.plan.destinations() <= set(range(16,24))}")

    print("=== 3. serving fleet: failure storm with Memento wrapper ===")
    fd = FailureDomain(32)
    keys = list(range(10000))
    before = {k: fd.locate(k) for k in keys}
    fd.fail(7)
    fd.fail(19)
    moved = sum(1 for k in keys if fd.locate(k) != before[k])
    print(f"2 replicas failed: {moved/len(keys):.4f} of sessions moved (ideal ~{2/32:.4f})")
    fd.recover(7)
    fd.recover(19)
    print(f"recovered: placement restored = {all(fd.locate(k)==before[k] for k in keys)}")

    print("=== 4. checkpoint storage: 8 -> 10 nodes ===")
    cfg = reduced_config("mamba2-1.3b")
    params = M.init_train_params(torch.Generator(device).manual_seed(0), cfg)
    state = make_train_state(params, make_optimizer("adamw"), TrainHparams())
    with tempfile.TemporaryDirectory(prefix="repro_torch_elastic_ckpt_") as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, n_nodes=8)
        moves = mgr.plan_resize(state, 10)
    n_leaves = len(leaves(state))
    print(f"checkpoint leaves to move: {len(moves)}/{n_leaves} "
          f"(ideal ~{n_leaves*2//10}); targets new nodes only: "
          f"{all(dst >= 8 for _, _, dst in moves)}")


if __name__ == "__main__":
    main()
