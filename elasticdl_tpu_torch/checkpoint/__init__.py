from elasticdl_tpu_torch.checkpoint.saver import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointSaver,
    check_params_flat,
    flatten_state,
    get_latest_checkpoint_version,
    load_checkpoint,
    restore_params_from_flat,
    restore_state_from_checkpoint,
    restore_state_from_flat,
    verify_checkpoint,
)
