from .rules import (P, AxisRules, axis_rules, batch_spec, current_rules,
                    logical_constraint, logical_spec, param_specs, placements)

__all__ = ["P", "AxisRules", "axis_rules", "current_rules", "logical_constraint",
           "logical_spec", "param_specs", "batch_spec", "placements"]
