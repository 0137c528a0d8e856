from .pipeline import PipelineConfig, SyntheticLM
