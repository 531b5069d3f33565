from cu2rec_torch.utils.config import Config

__all__ = ["Config"]
