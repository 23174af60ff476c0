"""The one traffic generator: the cycle of prompt lengths is the same for
every seed and holds its stated range and mean; the compared sample holds
the longest and the shortest request and follows the seed."""
import math

import pytest

from bench.harness import spec
from bench.harness import traffic as tr


@pytest.mark.parametrize("name,lo,hi,n", [("prefill", 187, 8192, 32),
                                         ("prefill-long", 16384, 32768, 16)])
def test_cycle_spans_its_range_with_the_log_uniform_mean(name, lo, hi, n):
    mix = spec.traffic(name)
    cycle = tr.length_cycle(mix)
    assert len(cycle) == n == len(set(cycle))
    assert lo <= min(cycle) and max(cycle) <= hi
    mean = (hi - lo) / math.log(hi / lo)  # the log-uniform law's mean
    assert abs(sum(cycle) / n - mean) / mean < 0.005
    # every stretch of a quarter cycle reaches below and above the median
    med = sorted(cycle)[n // 2]
    for start in range(0, n, n // 4):
        part = cycle[start:start + n // 4]
        assert min(part) < med <= max(part)


def test_issue_means():
    assert round(sum(tr.length_cycle(spec.traffic("prefill"))) / 32) == 2117
    assert round(sum(tr.length_cycle(
        spec.traffic("prefill-long"))) / 16) == 23635


def test_short_mix_has_the_traces_median():
    """The law's median is the geometric mean of the two published medians
    the mix cites (1,020 and 1,500 tokens), within rounding of a bound."""
    law = spec.traffic("prefill")["lengths"]
    assert abs(math.sqrt(law["min"] * law["max"])
               - math.sqrt(1020 * 1500)) < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7, 2**40 + 3, -5])
def test_lengths_and_sessions_do_not_depend_on_the_seed(seed):
    mix = spec.traffic("prefill")
    assert [tr.length_of(mix, i) for i in range(100)] == \
        [tr.length_cycle(mix)[i % 32] for i in range(100)]
    assert [tr.session_of(mix, i) for i in range(130)][64:] == \
        [f"s{i}" for i in range(64)] + ["s0", "s1"]
    s = tr.sub_seed(seed, "tokens", 3)
    assert 0 <= s < 2**63 and s == tr.sub_seed(seed, "tokens", 3)
    assert s != tr.sub_seed(seed, "tokens", 4)


def test_compared_sample_holds_the_longest_and_follows_the_seed():
    lengths = [5, 9, 3, 9, 1, 7, 2]
    a = tr.compared(lengths, 3, seed=11)
    assert 1 in a and len(a) == 3 == len(set(a))  # the first of the longest
    assert 4 in a  # and the shortest
    assert tr.compared(lengths, 1, seed=11) == [1]
    assert tr.compared([4, 4], 2, seed=3) == [0, 1]
    assert a == tr.compared(lengths, 3, seed=11)
    assert any(tr.compared(lengths, 3, seed=s) != a for s in range(12, 20))
    assert tr.compared(lengths[:2], 5, seed=1) == [0, 1]
    assert tr.compared([], 3, seed=1) == []


def test_warmup_takes_the_longest_then_the_shortest():
    mix = spec.traffic("prefill")
    assert tr.warmup_lengths(mix) == [max(tr.length_cycle(mix)),
                                      min(tr.length_cycle(mix))]
