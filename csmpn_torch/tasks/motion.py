"""Motion task entry.

    python -m csmpn_torch.tasks.motion \\
        --trainer.module=csmpn_torch.engineer.Trainer \\
        --dataset.module=csmpn_torch.data.motion.MotionDataset \\
        --optimizer.module=csmpn_torch.engineer.optim.adam \\
        --model.module=csmpn_torch.models.motion.MotionModel [--device=cpu]
"""
from csmpn_torch.engineer.fire import fire
from csmpn_torch.tasks.common import run_task


def main(config):
    return run_task(config)


if __name__ == "__main__":
    fire(main)
