"""Component stamp models: lowering of circuit components to MNA stamp tensors."""

from nodal_tpu_torch.models.stamps import (  # noqa: F401
    Quirks,
    StampTensors,
    compile_stamps,
    stamps_from_reference,
)
