"""NBA trajectory-prediction task entry.

    python -m csmpn_torch.tasks.nba \\
        --trainer.module=csmpn_torch.engineer.Trainer \\
        --dataset.module=csmpn_torch.data.nba.NBADataset \\
        --optimizer.module=csmpn_torch.engineer.optim.adam \\
        --model.module=csmpn_torch.models.nba.NBAModel \\
        --trainer.max_steps=10000 [--device=cpu] [--precision=exact]
"""
from csmpn_torch.engineer.fire import fire
from csmpn_torch.tasks.common import run_task


def main(config):
    return run_task(config)


if __name__ == "__main__":
    fire(main)
