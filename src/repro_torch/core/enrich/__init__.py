from repro_torch.core.enrich.ops import (  # noqa: F401
    contains_any,
    pairwise_dist2,
    point_in_rect,
    radius_count,
    radius_topk,
    segment_count,
    segment_sum,
    segment_topk,
    sorted_join,
)
from repro_torch.core.enrich.queries import (  # noqa: F401
    ALL_UDFS,
    EnrichUDF,
    get_udf,
    make_reference_tables,
)
