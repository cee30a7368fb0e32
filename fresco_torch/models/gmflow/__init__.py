from fresco_torch.models.gmflow.model import GMFlow, GMFlowConfig

__all__ = ["GMFlow", "GMFlowConfig"]
