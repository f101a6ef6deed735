"""RULER-equivalent synthetic long-context benchmark on the port's engine
(port of `magicpig_tpu/evals/ruler/`).

Synthetic task generation, the prediction driver (greedy decoding at
temperature 0 through `LLM.generate`) and string-match scoring, after the
reference's vendored NVIDIA RULER (`evaluations/RULER/`): 13 tasks, 50
samples each (`config_models.sh:15-23`, `config_tasks.sh:32-46`,
`eval/synthetic/constants.py:25-48`). `model_config` is the byte-level
model `data/ruler_lm_v2.npz` holds (trained by
`examples/train_ruler_lm.py`).
"""

from magicpig_tpu_torch.evals.ruler.tasks import TASK_SUITE, generate_task  # noqa: F401
from magicpig_tpu_torch.evals.ruler.score import (  # noqa: F401
    score_predictions,
    string_match_all,
    string_match_part,
)
from magicpig_tpu_torch.evals.ruler.predict import (  # noqa: F401
    model_config,
    predict_task,
    run_suite,
)
