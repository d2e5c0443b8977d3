from slam_toolbox_tpu_torch.api.slam import (  # noqa: F401
    MatchType, ProcessType, SlamSession,
)
