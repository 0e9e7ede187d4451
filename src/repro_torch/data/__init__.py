"""Data substrate: paper-dataset-shaped stream generators, the paper's real
jobs 1–4 as topologies, and the sharded token pipeline for the LM
workloads."""

from repro_torch.data.jobs import real_job_1, real_job_2, real_job_3, real_job_4
from repro_torch.data.pipeline import PipelineConfig, Prefetcher, ShardStats, TokenPipeline
from repro_torch.data.synthetic import (
    StreamSpec,
    airline_stream,
    weather_stream,
    wiki_edit_stream,
)

__all__ = [
    "PipelineConfig",
    "Prefetcher",
    "ShardStats",
    "TokenPipeline",
    "StreamSpec",
    "airline_stream",
    "weather_stream",
    "wiki_edit_stream",
    "real_job_1",
    "real_job_2",
    "real_job_3",
    "real_job_4",
]
