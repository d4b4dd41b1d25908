from repro_torch.core.merge import (condition_numbers, merge_skipless,
                                    removed_weight_count)

__all__ = ["condition_numbers", "merge_skipless", "removed_weight_count"]
