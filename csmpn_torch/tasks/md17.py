"""MD17 atomic-motion task entry.

    python -m csmpn_torch.tasks.md17 \\
        --trainer.module=csmpn_torch.engineer.Trainer \\
        --dataset.module=csmpn_torch.data.md17.MD17Dataset \\
        --optimizer.module=csmpn_torch.engineer.optim.adam \\
        --model.module=csmpn_torch.models.md17.MD17Model \\
        --trainer.max_steps=150000 [--device=cpu] [--precision=exact]
"""
from csmpn_torch.engineer.fire import fire
from csmpn_torch.tasks.common import run_task


def main(config):
    return run_task(config)


if __name__ == "__main__":
    fire(main)
