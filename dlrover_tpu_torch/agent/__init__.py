"""The per-node agent of the port — so far its checkpoint saver
(:mod:`dlrover_tpu_torch.agent.ckpt_saver`)."""
