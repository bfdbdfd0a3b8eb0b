from repro_torch.data.emnist_like import (  # noqa: F401
    EmnistLikeFederated,
    generate_dataset,
    similarity_split,
)
from repro_torch.data.quadratics import (  # noqa: F401
    ProceduralQuadraticDataset,
    QuadraticDataset,
    make_paper_fig3,
    make_similarity_quadratics,
    quadratic_loss,
)
from repro_torch.data.synthetic_lm import SyntheticLMFederated  # noqa: F401
