"""Convex-hulls task entry.

    python -m csmpn_torch.tasks.hulls \\
        --trainer.module=csmpn_torch.engineer.Trainer \\
        --dataset.module=csmpn_torch.data.hulls.ConvexHullDataset \\
        --optimizer.module=csmpn_torch.engineer.optim.adam \\
        --model.module=csmpn_torch.models.hulls.HullsModel \\
        --trainer.max_steps=131072 [--device=cpu] [--precision=exact]
"""
from csmpn_torch.engineer.fire import fire
from csmpn_torch.tasks.common import run_task


def main(config):
    return run_task(config)


if __name__ == "__main__":
    fire(main)
