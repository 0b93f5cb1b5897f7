"""Child process of ``tests/test_torch_distributed.py``.

Joins a process group of ``world`` processes on the CPU (gloo over
loopback, a 60 s collective timeout) and runs the port's multi-process
data parallelism on the mini spec:

    python torch_mp_child.py step <rank> <world> <port> <work_dir>
    python torch_mp_child.py trainer <rank> <world> <port> <work_dir>

``step``: one global train step (``shard_train_step_multiprocess``) on
this rank's rows of the parent's batch (``<work_dir>/setup.pt``), without
and then with augmentation; prints each loss, and rank 0 saves the
parameters after each step.  ``trainer``: ``Trainer(distributed=True)``
on the parent's data set, writing under ``<work_dir>/rank<rank>``.
Imports only the PyTorch package.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))  # the repository root


def step(rank: int, world: int, work: str) -> None:
    import torch
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    from amyloid_yolo_tpu_torch.parallel import distributed as D
    from amyloid_yolo_tpu_torch.parallel import steps

    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    spec = from_cfg(os.path.join(work, "mini.cfg"))
    imgs, targets, mask, cap = setup["imgs"], setup["targets"], setup["mask"], setup["cap"]
    b = D.local_batch_size(len(imgs), D.global_mesh())
    lo, hi = rank * b, (rank + 1) * b
    for augment in (False, True):
        opt = steps.make_optimizer(setup["lr"])
        state = steps.init_train_state(setup["params"], opt, device="cpu")
        sharded = D.shard_train_step_multiprocess(
            steps.make_train_step(spec, opt, augment=augment), D.global_mesh())
        # this rank's rows; their targets keep the global batch indices
        state, m = sharded(state, imgs[lo:hi], targets[lo * cap:hi * cap],
                           mask[lo * cap:hi * cap], torch.Generator().manual_seed(3), 64)
        print(f"MP_LOSS {augment} {float(D.fetch_replicated(m['loss']))!r}", flush=True)
        if rank == 0:
            torch.save({k: v.detach() for k, v in state.params.items()},
                       os.path.join(work, f"params_{augment}.pt"))


def trainer(rank: int, world: int, work: str) -> None:
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    from amyloid_yolo_tpu_torch.training import Trainer, TrainConfig

    out = os.path.join(work, f"rank{rank}")
    cfg = TrainConfig(data_config=os.path.join(work, "data", "custom.data"), epochs=2,
                      batch_size=4, gradient_accumulations=1, img_size=64, multiscale=False,
                      augment=False, evaluation_interval=1,
                      checkpoint_dir=os.path.join(out, "ckpt"), logdir=os.path.join(out, "logs"),
                      seed=0, distributed=True, num_processes=world, verbose=True)
    tr = Trainer(cfg, spec=from_cfg(os.path.join(work, "mini.cfg")), device="cpu")
    assert (tr.pid, tr.nproc, tr.is_main) == (rank, world, rank == 0)
    tr.train()


def main() -> None:
    mode, rank, world, port, work = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    from amyloid_yolo_tpu_torch.parallel import distributed as D

    torch.set_num_threads(2)
    D.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu", timeout=60)
    {"step": step, "trainer": trainer}[mode](rank, world, work)
    torch.distributed.destroy_process_group()
    print("MP_OK", flush=True)


if __name__ == "__main__":
    main()
