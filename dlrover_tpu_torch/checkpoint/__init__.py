"""Flash checkpointing for the port — the counterpart of
``dlrover_tpu/checkpoint``: the training state is staged into a POSIX shm
arena (the train stall), persisted to storage by a background thread with a
done-file commit protocol, and restored from the still-warm arena, else
from storage.  The shard files are the reference's v2 format, byte for
byte.  Submodules are imported where they are used, so that ``python -m
dlrover_tpu_torch.checkpoint.fsck`` stays light."""
