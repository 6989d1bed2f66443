// Streaming closed-loop Gen2 decode engine (native runtime path).
//
// The reference implements its runtime as three GNU Radio C++ blocks driven
// by a scheduler (gate_impl.cc / tag_decoder_impl.cc / reader_impl.cc); this
// is the equivalent native component for the TPU-first framework: a
// single-pass, sample-streaming decoder used as
//   (a) the low-latency CPU path for live/streamed captures,
//   (b) an independent oracle to cross-validate the batched JAX pipeline.
//
// It is a fresh implementation designed from the Gen2 protocol facts in
// SURVEY.md sections 2.3/2.4 (same arithmetic: integer truncations, float
// half-bit stepping, windowed running means) - not a port of the reference's
// block/scheduler structure: there is no scheduler, no shared global state,
// just one explicit FSM advanced per sample with an inline matched filter.
//
// Build: see build.py (g++ -O3 -shared).  ABI: plain C, used via ctypes.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using cf = std::complex<float>;

struct Params {
  // Derived sample counts at the post-decimation rate (SURVEY.md 2.4).
  int32_t decim;            // matched-filter decimation (5)
  int32_t n_taps;           // boxcar taps (25)
  int32_t win_length;       // amplitude window (100)
  int32_t dc_length;        // DC window (48)
  int32_t n_samples_t1;     // T1 quiet (96)
  int32_t pw_half;          // min pulse low-run (2)
  int32_t num_pulses_command;  // 5
  float thresh_fraction;    // 0.75
  float n_samples_tag_bit;  // 10.0 (float: decoder semantics)
  int32_t rn16_window;      // 250
  int32_t epc_window;       // 1370
  int32_t rn16_half_bits;   // 32
  int32_t epc_data_bits;    // 128
  int32_t tag_preamble_bits;  // 6
  int32_t max_slot;         // 2^Q
  int32_t max_queries;      // termination limit
  int32_t max_unique;       // termination limit
  int32_t pc_length;        // 1 = PC-driven variable-length EPC validation
  int32_t miller_m;         // 1 = FM0, 2/4/8 = Miller subcarrier
  int32_t trext;            // Miller spin-up length select (4 vs 16 bits)
};

struct Stats {
  int32_t n_queries;
  int32_t cur_round;
  int32_t cur_slot;
  int32_t n_epc_correct;
  int32_t n_events;
  int32_t terminated;
  int32_t tag_reads[256];
};

constexpr int kPreambleHalfBits = 12;
// FM0 preamble half-bit pattern as +-1 (global_vars.h:136 / SURVEY.md 2.3).
constexpr float kPreamblePm[kPreambleHalfBits] = {1, 1, -1, 1, -1, -1,
                                                  1, -1, -1, -1, 1, 1};
// High preamble chips used for the channel estimate.
constexpr int kHChips[6] = {0, 1, 3, 6, 10, 11};

uint16_t crc16_ccitt(const uint8_t* bits, int n_bits) {
  uint16_t crc = 0xFFFF;
  for (int i = 0; i < n_bits / 8; ++i) {
    uint8_t byte = 0;
    for (int j = 0; j < 8; ++j) byte = (byte << 1) | bits[i * 8 + j];
    crc ^= static_cast<uint16_t>(byte) << 8;
    for (int j = 0; j < 8; ++j)
      crc = (crc & 0x8000) ? (crc << 1) ^ 0x1021 : crc << 1;
  }
  return ~crc;
}

// Miller-M baseband+subcarrier chips of the Gen2 preamble as +-1 (the
// same rules as sim/tag.py::miller_chips: data-1 inverts phase mid-bit,
// consecutive data-0s invert at the boundary, M subcarrier half-cycles
// per half-bit; preamble = 4 (TRext=0) / 16 (TRext=1) spin-up zeros then
// 010111).
std::vector<float> miller_preamble_pm(int m, int trext) {
  std::vector<int> bits;
  for (int i = 0; i < (trext ? 16 : 4); ++i) bits.push_back(0);
  for (int b : {0, 1, 0, 1, 1, 1}) bits.push_back(b);
  std::vector<float> chips;
  int cur = 1, prev_bit = 1;
  for (size_t i = 0; i < bits.size(); ++i) {
    if (i > 0 && bits[i] == 0 && prev_bit == 0) cur = -cur;
    for (int k = 0; k < 2 * m; ++k) {
      int sub = (k % 2 == 0) ? 1 : -1;
      int flip = (bits[i] == 1 && k >= m) ? -1 : 1;  // data-1 mid-bit
      chips.push_back(static_cast<float>(cur * sub * flip));
    }
    if (bits[i] == 1) cur = -cur;
    prev_bit = bits[i];
  }
  return chips;
}

class Engine {
 public:
  Engine(const Params& p) : p_(p) {
    win_.assign(p.win_length, 0.f);
    dcbuf_.assign(p.dc_length, cf(0.f, 0.f));
    fir_hist_.assign(p.n_taps, cf(0.f, 0.f));
    window_.reserve(p.epc_window);
    if (p.miller_m > 1)
      miller_pm_ = miller_preamble_pm(p.miller_m, p.trext);
    std::memset(&st_, 0, sizeof(st_));
    st_.cur_round = 1;
    st_.cur_slot = 1;
  }

  // Feed interleaved float32 I/Q at ADC rate.
  void feed(const float* iq, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      fir_push(cf(iq[2 * i], iq[2 * i + 1]));
    }
  }

  const Stats& stats() const { return st_; }
  int64_t events(int32_t* out, int64_t cap) const {
    int64_t n = std::min<int64_t>(cap, event_idx_.size());
    std::memcpy(out, event_idx_.data(), n * sizeof(int32_t));
    return n;
  }

 private:
  // ---- inline boxcar FIR + decimator (reference matched filter) ----
  // Alignment matches the zero-history convention: y[k] is the tap window
  // ending at ADC sample k*decim, so the first real sample produces y[0].
  // O(1)/sample: running boxcar sum over a ring buffer, with a periodic
  // exact rebuild to stop f32 drift from the add/subtract recurrence.
  void fir_push(cf x) {
    fir_sum_ += x - fir_hist_[fir_pos_];
    fir_hist_[fir_pos_] = x;
    fir_pos_ = fir_pos_ + 1 == p_.n_taps ? 0 : fir_pos_ + 1;
    if (++fir_phase_ == p_.decim) {
      fir_phase_ = 0;
      if (++fir_since_rebuild_ >= 4096) {
        fir_since_rebuild_ = 0;
        cf acc(0.f, 0.f);
        for (int j = 0; j < p_.n_taps; ++j) acc += fir_hist_[j];
        fir_sum_ = acc;
      }
      gate_push(fir_sum_);
    }
  }

  // ---- gate FSM: one post-decimation sample at a time ----
  void gate_push(cf x) {
    if (st_.terminated) return;
    float ampl = std::abs(x);
    avg_ += (ampl - win_[win_i_]) / p_.win_length;
    win_[win_i_] = ampl;
    win_i_ = (win_i_ + 1) % p_.win_length;
    float thresh = avg_ * p_.thresh_fraction;

    if (!open_) {
      dc_ += (x - dcbuf_[dc_i_]) / cf(static_cast<float>(p_.dc_length), 0.f);
      dcbuf_[dc_i_] = x;
      dc_i_ = (dc_i_ + 1) % p_.dc_length;
      ++run_;
      if (ampl < thresh && state_pos_) {
        run_ = 0;
        state_pos_ = false;
      } else if (ampl > thresh && !state_pos_) {
        state_pos_ = true;
        pulses_ = (run_ > p_.pw_half) ? pulses_ + 1 : 0;
        run_ = 0;
      }
      if (run_ > p_.n_samples_t1 && state_pos_ &&
          pulses_ > p_.num_pulses_command) {
        open_ = true;
        pulses_ = 0;
        run_ = 0;
        window_.clear();
        event_idx_.push_back(static_cast<int32_t>(y_index_));
        ++st_.n_events;
        window_.push_back(x - dc_);
      }
    } else {
      window_.push_back(x - dc_);
      int want = expect_epc_ ? p_.epc_window : p_.rn16_window;
      if (static_cast<int>(window_.size()) >= want) {
        open_ = false;
        run_ = 0;
        decode_window();
      }
    }
    ++y_index_;
  }

  // ---- frame sync: preamble correlation + channel estimate ----
  int sync(cf* h_out) const {
    if (p_.miller_m > 1) return miller_sync(h_out);
    const float half = p_.n_samples_tag_bit / 2.f;
    int n_off = static_cast<int>(1.5f * p_.n_samples_tag_bit);
    float best = 0.f;
    int best_i = 0;
    for (int i = 0; i < n_off; ++i) {
      cf corr(0.f, 0.f);
      for (int j = 0; j < 2 * p_.tag_preamble_bits; ++j)
        corr += window_[i + static_cast<int>(j * half)] * kPreamblePm[j];
      float pw = std::norm(corr);
      if (pw > best) {
        best = pw;
        best_i = i;
      }
    }
    cf h(0.f, 0.f);
    for (int k : kHChips) h += window_[best_i + static_cast<int>(k * half)];
    *h_out = h / cf(6.f, 0.f);
    return best_i +
           static_cast<int>(p_.tag_preamble_bits * p_.n_samples_tag_bit + half);
  }

  // Miller sync: +-1 chip-template correlation (dsp/miller.py::miller_sync
  // semantics, nominal clock); returns the first data-chip index and the
  // channel estimate h = corr / n_chips.
  int miller_sync(cf* h_out) const {
    const float d = chip_d();
    const int n_chips = static_cast<int>(miller_pm_.size());
    int n_off = static_cast<int>(1.5f * p_.n_samples_tag_bit);
    float best = 0.f;
    int best_i = 0;
    cf best_h(0.f, 0.f);
    for (int i = 0; i < n_off; ++i) {
      cf corr(0.f, 0.f);
      for (int j = 0; j < n_chips; ++j)
        corr += window_[i + static_cast<int>(j * d)] * miller_pm_[j];
      float pw = std::norm(corr);
      if (pw > best) {
        best = pw;
        best_i = i;
        best_h = corr / cf(static_cast<float>(n_chips), 0.f);
      }
    }
    *h_out = best_h;
    return best_i + static_cast<int>(std::lround(n_chips * d));
  }

  float chip_d() const {
    return p_.n_samples_tag_bit / (2.f * p_.miller_m);
  }

  // Half-bit subcarrier correlation q_hb = sum_a x[hb*m + a] * (-1)^a.
  cf miller_halfbit(int idx, int hb) const {
    const float d = chip_d();
    const int m = p_.miller_m;
    cf q(0.f, 0.f);
    for (int a = 0; a < m; ++a) {
      int k = idx + static_cast<int>((static_cast<float>(hb) * m + a) * d);
      if (k < static_cast<int>(window_.size()))
        q += window_[k] * ((a % 2 == 0) ? 1.f : -1.f);
    }
    return q;
  }

  void decode_window() {
    cf h;
    int idx = sync(&h);
    if (!expect_epc_) {
      // RN16: bits decoded but (as in the closed loop) the reply itself only
      // matters to the ACK the reader already sent; always advances to EPC.
      expect_epc_ = true;
      ++st_.n_queries;
      check_limits();
      return;
    }
    // EPC path.  FM0: symbol-period grid search on |window|^2 then FM0
    // slicing.  Miller: per-half-bit subcarrier correlation with the
    // within-bit phase comparison (dsp/miller.py semantics, nominal
    // clock - the JAX path owns the impaired-tag tolerance envelope).
    expect_epc_ = false;
    ++st_.cur_slot;
    uint8_t bits[256];
    if (p_.miller_m > 1) {
      for (int j = 0; j < p_.epc_data_bits; ++j) {
        cf q1 = miller_halfbit(idx, 2 * j);
        cf q2 = miller_halfbit(idx, 2 * j + 1);
        float s1 = std::real(q1 * std::conj(h));
        float s2 = std::real(q2 * std::conj(h));
        bits[j] = ((s1 > 0) != (s2 > 0)) ? 1 : 0;
      }
    } else {
      const float half = p_.n_samples_tag_bit / 2.f;
      const float lo = half - half / 100.f, hi = half + half / 100.f;
      float best_e = -1.f, T = half;
      for (int t = 0; t < 20; ++t) {
        float cand = lo + t * (hi - lo) / 19.f;
        float e = 0.f;
        for (int i = 0; i < 256; ++i) {
          int k = static_cast<int>(i * cand) + idx;
          if (k < static_cast<int>(window_.size())) e += std::norm(window_[k]);
        }
        if (e > best_e) {
          best_e = e;
          T = cand;
        }
      }
      int prev = 1;
      for (int j = 0; j < p_.epc_data_bits; ++j) {
        int i1 = static_cast<int>(j * (2 * T) + idx);
        int i2 = static_cast<int>(j * 2 * T + T + idx);
        float r = std::real((window_[i1] - window_[i2]) * std::conj(h));
        int s = r > 0 ? 1 : -1;
        bits[j] = (s != prev) ? 1 : 0;
        prev = s;
      }
    }
    // Frame validation: fixed length (the reference's EPC_BITS=129 check,
    // tag_decoder_impl.cc:317-327) or PC-driven variable length (Gen2
    // 6.3.2.1.2.2: PC bits 0-4 = EPC words; the id byte is the last EPC
    // byte, generalizing bits[104:112]).
    int data_len = p_.epc_data_bits - 16;
    if (p_.pc_length) {
      int l = 0;
      for (int j = 0; j < 5; ++j) l = (l << 1) | bits[j];
      data_len = 16 + 16 * l;
    }
    if (data_len + 16 <= p_.epc_data_bits) {
      uint16_t rcvd = 0;
      for (int j = 0; j < 16; ++j) rcvd = (rcvd << 1) | bits[data_len + j];
      if (crc16_ccitt(bits, data_len) == rcvd) {
        ++st_.n_epc_correct;
        int id = 0;
        for (int j = 0; j < 8; ++j) id = (id << 1) | bits[data_len - 8 + j];
        ++st_.tag_reads[id & 0xFF];
      }
    }
    if (st_.cur_slot > p_.max_slot) {
      st_.cur_slot = 1;
      ++st_.cur_round;
    }
    check_limits();
  }

  void check_limits() {
    int uniq = 0;
    for (int i = 0; i < 256; ++i) uniq += st_.tag_reads[i] > 0;
    if (st_.n_queries > p_.max_queries || uniq > p_.max_unique)
      st_.terminated = 1;
  }

  Params p_;
  Stats st_;
  // FIR state
  std::vector<cf> fir_hist_;
  cf fir_sum_ = cf(0.f, 0.f);
  int fir_pos_ = 0;
  int fir_since_rebuild_ = 0;
  int fir_phase_ = p_.decim - 1;  // first real sample completes phase 0
  // gate state
  std::vector<float> win_;
  std::vector<cf> dcbuf_;
  std::vector<cf> window_;
  std::vector<int32_t> event_idx_;
  float avg_ = 0.f;
  cf dc_ = cf(0.f, 0.f);
  int win_i_ = 0, dc_i_ = 0;
  int run_ = 0, pulses_ = 0;
  bool state_pos_ = false, open_ = false, expect_epc_ = false;
  int64_t y_index_ = 0;
  std::vector<float> miller_pm_;  // Miller preamble +-1 chip template
};

}  // namespace

extern "C" {

void* gen2_engine_new(const Params* p) { return new Engine(*p); }
void gen2_engine_free(void* e) { delete static_cast<Engine*>(e); }
void gen2_engine_feed(void* e, const float* iq, int64_t n) {
  static_cast<Engine*>(e)->feed(iq, n);
}
void gen2_engine_stats(void* e, Stats* out) {
  *out = static_cast<Engine*>(e)->stats();
}
int64_t gen2_engine_events(void* e, int32_t* out, int64_t cap) {
  return static_cast<Engine*>(e)->events(out, cap);
}

// One-shot convenience: decode a whole interleaved-f32 capture.
void gen2_decode_capture(const float* iq, int64_t n, const Params* p,
                         Stats* out) {
  Engine eng(*p);
  eng.feed(iq, n);
  *out = eng.stats();
}

}  // extern "C"
