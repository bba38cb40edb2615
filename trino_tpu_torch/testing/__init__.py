from .runner import DistributedQueryRunner
