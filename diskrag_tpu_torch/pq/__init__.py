"""Product quantization (counterpart of `diskrag_tpu/pq/`): the batched
k-means, the plain and the residual quantizer, the int quantizer
(self-contained int8 / int4 rows, `pq/intq`) and the adaptive parameter
recommendation."""

from diskrag_tpu_torch.pq.adaptive import (
    PQRecommendation,
    calculate_adaptive_pq_params,
)
from diskrag_tpu_torch.pq.intq import IntQuantizer, IQTables, default_iq_cells
from diskrag_tpu_torch.pq.kmeans import kmeans_fit
from diskrag_tpu_torch.pq.product_quantizer import ProductQuantizer
from diskrag_tpu_torch.pq.residual import (
    ResidualPQ,
    RPQTables,
    default_n_coarse,
    pq_from_arrays,
)

__all__ = [
    "kmeans_fit",
    "ProductQuantizer",
    "ResidualPQ",
    "RPQTables",
    "IntQuantizer",
    "IQTables",
    "default_iq_cells",
    "default_n_coarse",
    "pq_from_arrays",
    "PQRecommendation",
    "calculate_adaptive_pq_params",
]
