"""Data substrate: paper-dataset-shaped stream generators and the paper's
real jobs 1–4 as topologies."""

from repro_torch.data.jobs import real_job_1, real_job_2, real_job_3, real_job_4
from repro_torch.data.synthetic import (
    StreamSpec,
    airline_stream,
    weather_stream,
    wiki_edit_stream,
)

__all__ = [
    "StreamSpec",
    "airline_stream",
    "weather_stream",
    "wiki_edit_stream",
    "real_job_1",
    "real_job_2",
    "real_job_3",
    "real_job_4",
]
