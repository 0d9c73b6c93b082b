from repro_torch.sharding.specs import (PS, AxisRules, DEFAULT_RULES,
                                        logical_spec, placements, spec_tree,
                                        with_logical_constraint)

__all__ = ["PS", "AxisRules", "DEFAULT_RULES", "logical_spec", "placements",
           "spec_tree", "with_logical_constraint"]
