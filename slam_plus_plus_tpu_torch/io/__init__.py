"""Dataset ingestion and synthetic dataset generators."""
