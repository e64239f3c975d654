"""The job master of the port — the counterpart of ``dlrover_tpu/master/``
for a training job on one host: ``LocalJobMaster`` and its managers,
started as ``python -m dlrover_tpu_torch.master.main``."""
