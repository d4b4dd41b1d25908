from repro_torch.core.analysis import (active_weights_per_token,
                                       decode_ms_per_token, decode_speedup,
                                       weight_table)
from repro_torch.core.merge import (condition_numbers, merge_skipless,
                                    removed_weight_count)

__all__ = ["active_weights_per_token", "condition_numbers",
           "decode_ms_per_token", "decode_speedup", "merge_skipless",
           "removed_weight_count", "weight_table"]
