"""Input pipeline of the port: so far the dynamic sharding client
(:mod:`dlrover_tpu_torch.data.sharding`)."""
