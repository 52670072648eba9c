from rmem_tpu_torch.memory.bank import (  # noqa: F401
    MemoryBank,
    bank_append,
    init_bank,
    valid_slot_mask,
    write_slot,
)
from rmem_tpu_torch.memory.eviction import update_bank_inplace  # noqa: F401
