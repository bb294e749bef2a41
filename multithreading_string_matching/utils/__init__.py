from multithreading_string_matching.utils.timing import PhaseTimer
from multithreading_string_matching.utils.report import format_report

__all__ = ["PhaseTimer", "format_report"]
