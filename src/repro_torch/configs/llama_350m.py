"""Paper LLaMA 350m config (see llama_paper.py)."""
from repro_torch.configs.llama_paper import LLAMA_350M as CONFIG, smoke

SMOKE = smoke(CONFIG)
