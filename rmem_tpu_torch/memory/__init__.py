from rmem_tpu_torch.memory.bank import (  # noqa: F401
    MemoryBank,
    bank_append,
    bank_appended,
    bank_compact,
    init_bank,
    valid_slot_mask,
    write_slot,
)
from rmem_tpu_torch.memory.eviction import (  # noqa: F401
    evict_if_full,
    update_bank_inplace,
)
