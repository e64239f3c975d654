"""Diagnosis of the port: the agent's failure diagnosis
(:mod:`dlrover_tpu_torch.diagnosis.agent`) and the master's diagnosis
manager (:mod:`~dlrover_tpu_torch.diagnosis.manager` over the data store,
the inference chain and its operators)."""
