"""HF Hub upload of a finished run directory (a copy of
`rgbdseg_tpu/train/hub.py`).

Capability parity with the reference's `trainer.push_to_hub(**kwargs)`
(reference: finetuning.py:141-149): after training, the output directory —
model card README.md, trainer_state.json, *_results.json, the HF export and
the checkpoints — is uploaded as a model repo. Network/hub access is optional:
without `huggingface_hub` installed (or offline), this logs what WOULD be
pushed and returns False, leaving the fully-assembled directory on disk.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def push_to_hub(output_dir: str, repo_id: str | None = None, private: bool = True, token: str | None = None) -> bool:
    """Upload `output_dir` to the HF Hub as model repo `repo_id`.

    Returns True on success, False when the hub client is unavailable or the
    upload fails (the run directory is always left intact either way).
    """
    repo_id = repo_id or os.path.basename(os.path.normpath(output_dir))
    try:
        from huggingface_hub import HfApi
    except ImportError:
        logger.warning(
            "push_to_hub requested but huggingface_hub is not installed; "
            "skipping upload. The run directory %s is hub-ready — push it "
            "later with `huggingface-cli upload %s %s`.",
            output_dir,
            repo_id,
            output_dir,
        )
        return False
    try:
        api = HfApi(token=token)
        api.create_repo(repo_id, private=private, exist_ok=True)
        api.upload_folder(repo_id=repo_id, folder_path=output_dir)
        logger.info("pushed %s to hub repo %s", output_dir, repo_id)
        return True
    except Exception:
        logger.warning("hub upload of %s to %s failed", output_dir, repo_id, exc_info=True)
        return False
