"""Diagnosis of the port — so far the agent's failure diagnosis
(:mod:`dlrover_tpu_torch.diagnosis.agent`)."""
