from benchmark.reference.fresco_ref.models.gmflow.model import GMFlow, GMFlowConfig

__all__ = ["GMFlow", "GMFlowConfig"]
