from .hw import HW_H100, HW_V5E, Hardware
from .analysis import (CostCounter, cost_numbers, extrapolate, model_flops,
                       roofline_from_numbers, roofline_terms, Roofline)
from .comm import CollectiveCounter
from .memory import LiveBytes

__all__ = ["HW_H100", "HW_V5E", "Hardware", "CostCounter", "cost_numbers",
           "extrapolate", "model_flops", "roofline_from_numbers",
           "roofline_terms", "Roofline", "CollectiveCounter", "LiveBytes"]
