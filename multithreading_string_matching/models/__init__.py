from multithreading_string_matching.models.kmp import lps_table, kmp_dfa, stack_kmp_dfas
from multithreading_string_matching.models.aho_corasick import AhoCorasick

__all__ = ["lps_table", "kmp_dfa", "stack_kmp_dfas", "AhoCorasick"]
