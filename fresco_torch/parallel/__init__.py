"""Training and the device mesh: the UNet fine-tuning step (``train``),
GMFlow training (``flow_train``), its data (``flow_data``) and evaluation
(``flow_eval``); the ``(data, model)`` mesh's parameter split
(``sharding``), rendezvous and rank spawner (``distributed``), the sharded
sampler check (``smoke``) and the dry run (``dryrun``).  Counterpart of
``fresco_tpu/parallel/``.  The mesh and its collectives are
``fresco_torch/core/comm.py``, below the models."""
from fresco_torch.parallel.train import TrainState, make_train_state, train_step

__all__ = ["TrainState", "make_train_state", "train_step"]
