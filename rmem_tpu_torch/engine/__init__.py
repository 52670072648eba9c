from rmem_tpu_torch.engine.inference import (  # noqa: F401
    EngineState,
    InferenceEngine,
    resolve_device,
)
