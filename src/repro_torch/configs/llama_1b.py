"""Paper LLaMA 1b config (see llama_paper.py)."""
from repro_torch.configs.llama_paper import LLAMA_1B as CONFIG, smoke

SMOKE = smoke(CONFIG)
