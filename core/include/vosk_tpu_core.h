/* vosk_tpu native host runtime — C ABI.
 *
 * Role: the irregular host-side finishing work the reference does in C++
 * (lattice assembly/pruning, forward-backward posteriors, n-best; cf.
 * reference src/recognizer.cc:430-667) operating on the device decoder's
 * per-frame candidate records.  Consumed from Python via ctypes.
 */
#ifndef VOSK_TPU_CORE_H
#define VOSK_TPU_CORE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* One decoded word on an n-best path. */
typedef struct {
  int32_t word;        /* olabel id */
  int32_t start_frame; /* decoded-frame index (subsampled frames) */
  int32_t end_frame;
  float conf;          /* arc posterior */
} VtWord;

/* Input view of the decoder records for ONE channel, all chunks
 * concatenated on the time axis.  Layouts (C order):
 *   f_state, f_cost, pdf      : [T, L, K]
 *   lat_ns, lat_prev, lat_arc : [T, L, R]
 *   lat_cost                  : [T, L, R]
 * Arc lookup is through the dense padded tables (arc id = state*M + m):
 *   dense_w [S+1, M], dense_olabel [S+1, M], dense_pdf [S+1, M]
 * With M > 0 the em-level (lvl 0) lat_arc stores only the in-row slot m;
 * the dense arc id is reconstructed as prev_state * M + m, where
 * prev_state is the previous level's f_state at lat_prev.
 * Epsilon arcs use CSR tables (arc id indexes them directly).
 */
typedef struct {
  int32_t T, L, K, R;
  const int32_t *f_state;
  const float *f_cost;
  const int32_t *pdf;
  const int32_t *lat_ns;
  const int32_t *lat_prev;
  const int32_t *lat_arc;
  const float *lat_cost;
  /* graph side */
  int32_t num_states; /* S; sentinel = S */
  int32_t M;          /* dense arcs per state; 0 = CSR emitting tables */
  const float *dense_w;        /* [S+1, M] or NULL */
  const int32_t *dense_olabel; /* [S+1, M] or NULL */
  const int32_t *dense_pdf;    /* [S+1, M] or NULL */
  const float *em_w;           /* CSR fallback */
  const int32_t *em_olabel;
  const int32_t *em_pdf;
  const float *eps_w; /* epsilon arc tables (CSR ids) */
  const int32_t *eps_olabel;
  const float *final_cost; /* [S+1] */
  /* initial frontier */
  const int32_t *init_state; /* [K] */
  const float *init_cost;    /* [K] */
  /* olabel prefixes emitted by the start-state epsilon closure:
   * slot k's words are init_prefix_data[init_prefix_off[k] ..
   * init_prefix_off[k+1]).  May be NULL (no prefixes). */
  const int32_t *init_prefix_off;  /* [K+1] or NULL */
  const int32_t *init_prefix_data;
  /* finishing params */
  float lattice_beam;
  float graph_scale; /* 0.9 reference GraphLatticeScale */
  int32_t use_final;
  const int32_t *silence_pdfs;
  int32_t num_silence_pdfs;
} VtRecords;

typedef struct VtLattice VtLattice;

/* Build + prune the lattice.  Returns NULL on failure. */
VtLattice *vt_lattice_build(const VtRecords *rec);
void vt_lattice_free(VtLattice *lat);

int32_t vt_lattice_num_nodes(const VtLattice *lat);
int32_t vt_lattice_num_arcs(const VtLattice *lat);

/* Extract up to n best distinct-word-sequence paths.
 * out_words: caller buffer of cap entries; out_sizes[i] = word count of path
 * i; out_costs[i] = path cost.  Returns number of paths written. */
int32_t vt_lattice_nbest(VtLattice *lat, int32_t n, int32_t distinct,
                         VtWord *out_words, int32_t cap, int32_t *out_sizes,
                         float *out_costs, int32_t max_paths);

/* MBR sausage decoding (the reference MbrResult algorithm, Kaldi
 * lat/sausages.cc): one-best words re-estimated from sausage-bin
 * posteriors, with bin confidences and expected frame times.  Returns
 * word count written (<= cap), -1 on failure; *out_cost = lattice
 * best-path cost. */
int32_t vt_lattice_mbr(VtLattice *lat, VtWord *out_words, int32_t cap,
                       float *out_cost);

#ifdef __cplusplus
}
#endif

#endif /* VOSK_TPU_CORE_H */
