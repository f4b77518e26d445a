"""The port's sharded train loop (``train.loop.gpt_train_loop``) under
ray_tpu's ``TorchTrainer`` on the CPU (gloo), held to the same loop run
through ``parallel.launch.spawn`` without the trainer.

* The counterpart of tests/test_train.py's
  ``test_north_star_pp_fsdp_tp_gang_failure_resume``: 4 workers train a
  small GPT at pp2·tp2, checkpoint the gathered state every step, rank 1's
  process dies once after its step-1 report, and the trainer restarts the
  gang from the last checkpoint to step 3. Each step's reported loss must
  equal the spawned run's within 1e-5 (the resume is bitwise, so they are
  in fact equal).
* A 2-worker fsdp2 run fed from a ``ray_tpu.data`` dataset (each rank
  reading its split, the ranks' rows gathered into the global batch) must
  give the losses of the spawned run fed the same global batches.

``fit`` runs on a thread with its own time limit, and every spawn has one.
"""

import functools
import os
import threading

import numpy as np
import pytest

import ray_tpu
from ray_tpu_torch.parallel import launch

LOSS_ATOL = 1e-5

PP_LOOP = {"model": "gpt_nano", "model_overrides": {"num_layers": 2, "max_seq_len": 32,
                                                    "ce_chunk": 16},
           "mesh": {"pp": 2, "tp": 2}, "num_microbatches": 2, "batch": 4, "seq": 32,
           "steps": 4, "lr": 1e-3, "checkpoint_every": 1, "device": "cpu"}
DATA_LOOP = {"model": "gpt_nano", "model_overrides": {"max_seq_len": 32, "ce_chunk": 16},
             "mesh": {"fsdp": 2}, "batch": 4, "seq": 32, "steps": 3, "lr": 1e-3,
             "dataset": "train", "device": "cpu"}


class _Checkpoint:
    def __init__(self, data):
        self.data = data

    @classmethod
    def from_dict(cls, data):
        return cls(dict(data))

    def to_dict(self):
        return dict(self.data)


class _Shard:
    """A dataset shard over fixed rows."""

    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def iter_batches(self, batch_size, batch_format):
        assert batch_format == "numpy"
        for i in range(0, len(self.rows), batch_size):
            yield {"tokens": self.rows[i:i + batch_size]}


class _Session:
    """The loop's session without a runtime: reports kept in memory."""

    Checkpoint = _Checkpoint

    def __init__(self, rank, world, shard=None):
        self.rank, self.world, self.shard, self.reports = rank, world, shard, []

    def report(self, metrics, checkpoint=None):
        self.reports.append(dict(metrics))

    def get_checkpoint(self):
        return None

    def get_dataset_shard(self, name):
        return self.shard

    def get_world_rank(self):
        return self.rank

    def get_world_size(self):
        return self.world


def _spawned(config, shards, rank, world):
    from ray_tpu_torch.runtime import RecordingMetrics, RuntimeHooks
    from ray_tpu_torch.train.loop import gpt_train_loop

    session = _Session(rank, world, None if shards is None else _Shard(shards[rank]))
    gpt_train_loop(config, session=session, hooks=RuntimeHooks(metrics=RecordingMetrics()))
    return [(r["step"], r["loss"]) for r in session.reports]


def _fit(trainer, timeout: float):
    out = {}

    def run():
        out["result"] = trainer.fit()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"fit did not return within {timeout} s"
    return out["result"]


def _losses_by_step(history):
    """The last reported loss of each step (a resumed run reports some
    steps twice)."""
    out = {}
    for m in history:
        out[int(m["step"])] = float(m["loss"])
    return out


def test_torch_trainer_pp_tp_gang_failure_resume(ray_start_regular, tmp_path):
    from ray_tpu.train import FailureConfig, RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    marker = str(tmp_path / "killed_once")

    def loop(config):
        import os

        from ray_tpu import train
        from ray_tpu_torch.train.loop import gpt_train_loop
        from scripts.port_runtime_smoke import runtime_hooks

        class Session:
            """ray_tpu.train, and rank 1's process dying once after its
            step-1 report."""

            Checkpoint = train.Checkpoint
            get_checkpoint = staticmethod(train.get_checkpoint)
            get_dataset_shard = staticmethod(train.get_dataset_shard)
            get_world_rank = staticmethod(train.get_world_rank)
            get_world_size = staticmethod(train.get_world_size)

            @staticmethod
            def report(metrics, checkpoint=None):
                train.report(metrics, checkpoint=checkpoint)
                if (metrics["step"] == 1 and train.get_world_rank() == 1
                        and not os.path.exists(config["marker"])):
                    open(config["marker"], "w").close()
                    os._exit(1)  # chaos: the worker process dies mid-gang

        gpt_train_loop(config["loop"], session=Session, hooks=runtime_hooks())

    trainer = TorchTrainer(
        loop,
        train_loop_config={"loop": PP_LOOP, "marker": marker},
        scaling_config=ScalingConfig(num_workers=4, placement_strategy="PACK"),
        backend_config=TorchConfig("gloo"),
        run_config=RunConfig(name="port-northstar", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
    )
    result = _fit(trainer, timeout=240)
    assert result.error is None, f"the run failed: {result.error}"
    assert os.path.exists(marker), "the injected kill never fired"
    assert result.metrics["step"] == 3
    assert result.checkpoint.to_dict()["state"]["step"] == 4

    want = launch.spawn(functools.partial(_spawned, PP_LOOP, None), 4, device="cpu",
                        timeout=240)
    assert all(w == want[0] for w in want)  # the metrics are global
    got = _losses_by_step(result.metrics_history)
    assert sorted(got) == [0, 1, 2, 3]
    for step, loss in want[0]:
        assert abs(got[step] - loss) <= LOSS_ATOL, (step, got[step], loss)


def test_torch_trainer_feeds_the_loop_from_a_dataset(ray_start_regular, tmp_path):
    from ray_tpu import data as rt_data
    from ray_tpu.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    rows = np.random.RandomState(9).randint(0, 256, (12, 32)).astype(np.int64)
    ds = rt_data.from_numpy({"tokens": rows}, parallelism=2)
    # the rows each rank's shard holds: the trainer splits as split(equal) does
    splits = [np.concatenate([b["tokens"] for b in part.iter_batches(
        batch_size=None, batch_format="numpy")]) for part in ds.split(2, equal=True)]

    def loop(config):
        from ray_tpu import train
        from ray_tpu_torch.train.loop import gpt_train_loop

        gpt_train_loop(config, session=train)

    trainer = TorchTrainer(
        loop, train_loop_config=DATA_LOOP, datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=2),
        backend_config=TorchConfig("gloo"),
        run_config=RunConfig(name="port-data", storage_path=str(tmp_path)),
    )
    result = _fit(trainer, timeout=180)
    assert result.error is None, f"the run failed: {result.error}"
    want = launch.spawn(functools.partial(_spawned, DATA_LOOP, splits), 2, device="cpu",
                        timeout=180)
    got = _losses_by_step(result.metrics_history)
    assert sorted(got) == [0, 1, 2]
    for step, loss in want[0]:
        assert abs(got[step] - loss) <= LOSS_ATOL, (step, got[step], loss)


def test_loop_refuses_unknown_keys_and_a_missing_group():
    from ray_tpu_torch.train.loop import gpt_train_loop

    with pytest.raises(ValueError, match="unknown loop config keys"):
        gpt_train_loop({"stepz": 3}, session=_Session(0, 1))
    with pytest.raises(RuntimeError, match="process group"):
        gpt_train_loop({"device": "cpu"}, session=_Session(0, 1))
