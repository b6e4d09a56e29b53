"""Research loop: iterative candidate proposal and benchmark scoring, on the
card (counterpart of ``boxmot_tpu/engine/research``)."""

from boxmot_tpu_torch.engine.research.candidates import (  # noqa: F401
    Proposer,
    ast_mutation_proposer,
    create_proposer,
    llm_proposer,
)
from boxmot_tpu_torch.engine.research.runner import (  # noqa: F401
    PenaltyConfig,
    ResearchRunner,
    SourceResearchRunner,
    run_research,
)
