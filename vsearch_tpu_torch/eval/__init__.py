"""Evaluation: QA answer matching and retrieval metrics."""
from .qa_utils import SimpleTokenizer, has_answer, parse_qa_csv_file

__all__ = ["SimpleTokenizer", "has_answer", "parse_qa_csv_file"]
