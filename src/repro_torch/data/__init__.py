"""Data substrate: paper-dataset-shaped stream generators and the paper's
real jobs 2 and 3 as topologies."""

from repro_torch.data.jobs import real_job_2, real_job_3
from repro_torch.data.synthetic import StreamSpec, airline_stream

__all__ = ["StreamSpec", "airline_stream", "real_job_2", "real_job_3"]
