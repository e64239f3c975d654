"""The per-node agent of the port: the elastic training agent
(:mod:`~dlrover_tpu_torch.agent.training`), its client of the master
(:mod:`~dlrover_tpu_torch.agent.master_client`) and its checkpoint saver
(:mod:`~dlrover_tpu_torch.agent.ckpt_saver`)."""
