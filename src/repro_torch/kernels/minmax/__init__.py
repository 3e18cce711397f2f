from .ops import column_page_stats, column_page_stats_ex, page_minmax, segminmax_refine
from .ref import (
    bbox_query_keys,
    float_order_key_np,
    float_order_keys,
    inf_keys,
    inf_keys64,
    keep_from_minmax_ref,
    keys64,
    page_minmax_ref,
    segminmax_refine_ref,
    stack_bbox_query_keys,
)

__all__ = [
    "page_minmax",
    "page_minmax_ref",
    "column_page_stats",
    "column_page_stats_ex",
    "segminmax_refine",
    "segminmax_refine_ref",
    "float_order_keys",
    "float_order_key_np",
    "bbox_query_keys",
    "stack_bbox_query_keys",
    "inf_keys",
    "inf_keys64",
    "keys64",
    "keep_from_minmax_ref",
]
