"""Training on one device: the UNet fine-tuning step (``train``), GMFlow
training (``flow_train``), its data (``flow_data``) and evaluation
(``flow_eval``).  Counterpart of ``fresco_tpu/parallel/``; the mesh half
(``sharding``, ``distributed``, ``smoke``) is not ported yet."""
from fresco_torch.parallel.train import TrainState, make_train_state, train_step

__all__ = ["TrainState", "make_train_state", "train_step"]
