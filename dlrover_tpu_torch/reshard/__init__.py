"""Resharding for the port — so far only the planner's tiling proof
(:mod:`dlrover_tpu_torch.reshard.plan`), the counterpart of
``dlrover_tpu/reshard/plan.py`` that the checkpoint's coverage proof and
shard selection reach."""
