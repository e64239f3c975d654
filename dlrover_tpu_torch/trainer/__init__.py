"""The trainer SDK, what user training scripts import — the port's
counterpart of ``dlrover_tpu/trainer/__init__.py``, with the same names::

    import dlrover_tpu_torch.trainer as sdk

    ctx = sdk.init()
    trainer = sdk.Trainer(loss_fn=..., init_fn=..., args=sdk.TrainingArgs(
        ..., job_name=ctx.job_name), fetch_batch=..., dataset_size=N,
        strategy=Strategy(), master_client=ctx.client,
        step_reporter=ctx.report_step)
    trainer.train()

``init()`` brings up ``torch.distributed`` from the agent's env contract;
``ElasticTrainer``, ``ElasticSampler`` and ``ElasticDataLoader`` are the
elastic building blocks under ``Trainer``.
"""

from dlrover_tpu_torch.trainer.bootstrap import ElasticContext, init  # noqa: F401
from dlrover_tpu_torch.trainer.elastic import (  # noqa: F401
    ElasticDataLoader,
    ElasticTrainer,
    TrainerConfig,
    resolve_grad_accum,
)
from dlrover_tpu_torch.trainer.sampler import ElasticSampler  # noqa: F401
from dlrover_tpu_torch.trainer.trainer import (  # noqa: F401
    EarlyStoppingCallback,
    LoggingCallback,
    Trainer,
    TrainerCallback,
    TrainerControl,
    TrainerState,
    TrainingArgs,
    build_lr_schedule,
    build_optimizer,
)
